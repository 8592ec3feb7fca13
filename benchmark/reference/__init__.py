"""The plain reference: the served request in plain PyTorch, fp32 with TF32
off, written from the published models and the configuration alone.  It
imports nothing of the program and takes nothing the program made: the
benchmark hands it the same seeded weights, FLAME arrays and inputs that
it hands the program, and it works out the rest (the int8 steps and
weights, every chunk's noise) itself."""
