"""Where a background checkpoint's time goes on the GPU.

    python -m sr3d_torch.profile_checkpoint [--rounds N]

Builds the model2 joint step at the full width of
``configs/sr_sr3_VGGF2_16_128_model2.yml`` (bf16, random weights from seed
0, synthetic FLAME at the real size, N = K×B = 4 synthetic faces 16→128,
the DDIM-25 hand-off; its train state is the Trainer's checkpoint), warms
it up and takes one background save to allocate the host buffer, then,
``N`` rounds (default 2), for each npz writer in turns — ``direct``
(``train/checkpoint.py::_write_npz``, the port's) and ``savez``
(``np.savez``) — three steps with no write, a synchronous
``save_train_state``, and a background ``CheckpointManager.save``
followed at once by train steps until the write has finished.  Prints
each round's synchronous save, the background save's blocking seconds
(of them the snapshot), the writer's seconds, and the s/step of the steps
with no write against those that overlapped it; a JSON line last.

Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_checkpoint needs an NVIDIA GPU")
    from .config import get_cfg_defaults, update_cfg
    from .data.synthetic import synthetic_face_batch
    from .models.flame import synthetic_flame
    from .ops.image import degrade_pair
    from .train import checkpoint as ck
    from .train.joint import build_joint, init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = update_cfg(get_cfg_defaults(), str(
        ROOT / "configs" / "sr_sr3_VGGF2_16_128_model2.yml"))
    cfg.tpu.compute_dtype = "bfloat16"
    cfg.sr.model.diffusion.train_sampler = "ddim"
    cfg.sr.model.diffusion.train_ddim_steps = 25
    n = int(cfg.mica.datasets.K) * int(cfg.mica.datasets.batch_size)
    lo, hi = (int(cfg.sr.datasets.train.l_resolution),
              int(cfg.sr.datasets.train.r_resolution))
    hr = torch.from_numpy(synthetic_face_batch(n, hi, seed=0))
    g = torch.Generator().manual_seed(0)
    batch = {"HR": hr, "SR": degrade_pair(hr, lo, hi)[1],
             "flame_shape": torch.randn(
                 n, int(cfg.mica.model.n_shape), generator=g) * 0.3}
    flame = synthetic_flame(n_vertices=5023, n_shape=300, n_exp=100,
                            n_faces=9976, seed=0, device=dev)
    mods = build_joint(cfg, flame=flame, init_seed=0, device=dev)
    state = init_train_state(mods, cfg)
    step = make_train_step(cfg.sr.train.ema_scheduler)
    gen = torch.Generator(device=dev).manual_seed(0)

    def one() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, met = step(mods, state, batch, generator=gen)
        float(met["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(3):
        one()
    writers = {"direct": ck._write_npz,
               "savez": lambda f, arrays: np.savez(f, **arrays)}
    rounds = []
    with tempfile.TemporaryDirectory(prefix="profile_checkpoint_") as tmp:
        tmp = Path(tmp)
        mgr = ck.CheckpointManager(tmp / "checkpoint", max_to_keep=1)

        def meta():
            return {"epoch": 0, "global_step": state.step}

        t0 = time.perf_counter()
        mgr.save(state.step, mods, state, meta())
        first = {"blocking_s": time.perf_counter() - t0,
                 "alloc_mib": mgr.last_alloc_bytes / 2 ** 20}
        mgr.wait()
        first["write_s"] = mgr.poll()[0].seconds
        print(f"first background save: blocking {first['blocking_s']:.3f} s"
              f" ({first['alloc_mib']:.0f} MiB of pinned host buffer "
              f"allocated), writer {first['write_s']:.2f} s")
        try:
            for r in range(args.rounds):
                for name in (("direct", "savez") if r % 2 == 0
                             else ("savez", "direct")):
                    ck._write_npz = writers[name]
                    quiet = [one() for _ in range(3)]
                    t0 = time.perf_counter()
                    ck.save_train_state(tmp / "sync.npz", mods, state,
                                        meta())
                    sync_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    mgr.save(state.step, mods, state, meta())
                    block = time.perf_counter() - t0
                    overlap = []
                    while mgr.in_flight and len(overlap) < 20:
                        overlap.append(one())
                    mgr.wait()
                    (w,) = mgr.poll()
                    rec = {"writer": name, "sync_save_s": sync_s,
                           "blocking_s": block,
                           "snapshot_s": mgr.last_snapshot_s,
                           "write_s": w.seconds, "mib": w.nbytes / 2 ** 20,
                           "quiet_steps_s": quiet,
                           "overlapping_steps_s": overlap}
                    rounds.append(rec)
                    print(f"{name}: synchronous save {sync_s:.2f} s; "
                          f"background save blocking {block:.3f} s "
                          f"(snapshot {rec['snapshot_s']:.3f}), writer "
                          f"{w.seconds:.2f} s, {rec['mib']:.0f} MiB; "
                          f"s/step with no write "
                          f"{statistics.mean(quiet):.3f}, overlapping "
                          f"({len(overlap)}) "
                          + (f"{statistics.mean(overlap):.3f}"
                             if overlap else "none"))
        finally:
            ck._write_npz = writers["direct"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    out = {"device": smi, "first": first, "rounds": rounds}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
