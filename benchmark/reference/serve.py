"""A served request in plain PyTorch: LR faces → SR image (uint8), identity
code, FLAME vertices and 68 landmarks.

The request is cut into chunks of ``batch_size`` faces (the last padded
with zero conditioning), each chunk sampled with its own generator, seeded
by one ``randint(0, 2**62)`` drawn per chunk from the request's CPU
generator.  The LR faces are scaled to [−1, 1] and bicubic-upsampled to the
SR size as the condition; DDIM samples; the uint8 levels of the sample go
through the hand-off to ArcFace; the MICA branch decodes them.

``spec`` is the serving configuration as ``benchmark/run.py`` resolves it
from the configuration file and the traffic: ``unet`` (with
``quant_min_res`` and ``quant_resample``), ``image_size``, ``schedule``,
``sampler``, ``lr``, ``hr`` and ``mica``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import image, mica, sampler, unet
from .ops import Arith, no_tf32


def condition(lr_u8: np.ndarray, hr: int, device) -> torch.Tensor:
    """uint8 NHWC LR faces → the NHWC [−1, 1] condition at ``hr``."""
    x = torch.from_numpy(lr_u8.astype(np.float32) / 127.5 - 1.0).to(device)
    return x if x.shape[1] == hr else image.resize(x, hr, "bicubic")


def chunk_seeds(generator: torch.Generator, n_faces: int, batch_size: int
                ) -> list[int]:
    """One sampling seed per chunk of the request, as it is served."""
    return [int(torch.randint(0, 2 ** 62, (1,), generator=generator))
            for _ in range(0, n_faces, batch_size)]


def sample_chunk(params: dict, spec: dict, cond_nhwc: torch.Tensor,
                 seed: int, ar: Arith, quant: bool) -> torch.Tensor:
    """One padded chunk's SR sample, NHWC [−1, 1]."""
    u = spec["unet"]
    sched = sampler.linear_schedule(**spec["schedule"])
    gen = torch.Generator(cond_nhwc.device).manual_seed(seed)

    def denoise(x, gamma):
        return unet.unet_forward(params["unet"], u, spec["image_size"], x,
                                 gamma, ar, quant)

    s = spec["sampler"]
    out = sampler.ddim_sample(denoise, sched,
                              cond_nhwc.permute(0, 3, 1, 2).contiguous(),
                              gen, s["steps"], s["eta"], s["init"])
    return out.permute(0, 2, 3, 1)


@torch.no_grad()
def serve(params: dict, spec: dict, flame: dict, lr_u8: np.ndarray,
          generator: torch.Generator, batch_size: int, device,
          control: bool = False) -> dict:
    """The whole request; numpy ``sr_u8`` [N, hr, hr, 3] uint8,
    ``identity``, ``verts``, ``lmk68``."""
    ar = Arith(control=control)
    with no_tf32():
        cond = condition(lr_u8, spec["hr"], device)
        outs = []
        seeds = chunk_seeds(generator, cond.shape[0], batch_size)
        for seed, i in zip(seeds, range(0, cond.shape[0], batch_size)):
            c = cond[i:i + batch_size]
            keep = c.shape[0]
            if keep < batch_size:
                c = torch.cat([c, c.new_zeros((batch_size - keep,)
                                              + c.shape[1:])])
            sr = sample_chunk(params, spec, c, seed, ar,
                              quant=int(spec["unet"]["quant_min_res"]) > 0)
            u8 = image.to_uint8_levels(sr)
            res = mica.mica_forward(params, spec["mica"], flame,
                                    image.handoff(u8), ar)
            res["sr_u8"] = u8
            outs.append({k: v[:keep] for k, v in res.items()})
    out = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
    out["sr_u8"] = out["sr_u8"].astype(np.uint8)
    return out


@torch.no_grad()
def mica_of(params: dict, spec: dict, flame: dict, sr_u8: np.ndarray,
            device, control: bool = False, block: int = 32) -> dict:
    """The MICA branch on given SR images (uint8 NHWC), in blocks of
    ``block`` faces: numpy ``identity``, ``verts``, ``lmk68``.  ArcFace's
    BatchNorm normalises with running statistics, so the blocks do not
    change the answer."""
    ar = Arith(control=control)
    outs = []
    with no_tf32():
        for i in range(0, sr_u8.shape[0], block):
            u8 = torch.from_numpy(sr_u8[i:i + block].astype(np.float32)) \
                .to(device)
            outs.append(mica.mica_forward(params, spec["mica"], flame,
                                          image.handoff(u8), ar))
    return {k: torch.cat([o[k] for o in outs]).cpu().numpy()
            for k in outs[0]}
