"""Weight bridge between JAX parameter trees and the port's
``state_dict``s, both ways.

Input: ``{"sr": unet_vars, "arcface": params, "arcface_stats":
batch_stats, "mapping": params}`` as nested dicts of numpy arrays (the JAX
trees after ``jax.tree.map(np.asarray, ...)``), the layout of the JAX
package's ``JointTrainState.params`` plus its ArcFace BatchNorm statistics.

The port's modules carry the flax scope names, so each leaf maps by its own
name only:

* ``kernel`` → ``weight``: conv HWIO → OIHW, dense ``[in, out]`` →
  ``[out, in]``;
* ``scale``, ``bias``, ``alpha`` and the BatchNorm ``mean``/``var`` keep
  their names and values.

The EMA of the SR parameters is a UNet tree too (``load_jax_ema``), and
``export_jax_params`` / ``state_dict_to_flax`` go the other way, so a test
can hold parameters, EMA and BatchNorm statistics after a train step
against the JAX package's.

A reference PyTorch ``.pth`` reaches the port the same way: through the JAX
package's ``utils/convert.py`` into a flax tree, then through this bridge.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..diffusion.ema import EmaState


def _leaf(name: str, value: Any) -> tuple[str, torch.Tensor]:
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    if name == "kernel":
        if t.dim() == 4:
            return "weight", t.permute(3, 2, 0, 1).contiguous()
        if t.dim() == 2:
            return "weight", t.t().contiguous()
        raise ValueError(f"kernel of rank {t.dim()}")
    return name, t


def flax_to_state_dict(tree: Mapping[str, Any], prefix: str = ""
                       ) -> dict[str, torch.Tensor]:
    """Flatten a flax tree into dotted ``state_dict`` keys, converting each
    leaf.  A top-level ``{"params": ...}`` wrapper is dropped."""
    if prefix == "" and set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flax_to_state_dict(value, f"{prefix}{key}."))
        else:
            name, t = _leaf(key, value)
            out[prefix + name] = t
    return out


def load_jax_params(modules, tree: Mapping[str, Any]) -> None:
    """Copy a JAX joint parameter tree into ``modules`` (a
    ``train.joint.JointModules``), strictly: every port parameter must be
    covered and every JAX leaf used."""
    modules.unet.load_state_dict(flax_to_state_dict(tree["sr"]))
    arcface = flax_to_state_dict(tree["arcface"])
    arcface.update(flax_to_state_dict(tree.get("arcface_stats", {})))
    modules.arcface.load_state_dict(arcface)
    modules.mapping.load_state_dict(flax_to_state_dict(tree["mapping"]))


def load_jax_ema(tree: Mapping[str, Any], step: int,
                 device: str | torch.device = "cpu") -> EmaState:
    """A JAX ``EmaState.params`` tree (UNet variables) and its step as the
    port's ``EmaState``."""
    return EmaState(params={k: v.to(device)
                            for k, v in flax_to_state_dict(tree).items()},
                    step=int(step))


def state_dict_to_flax(sd: Mapping[str, torch.Tensor],
                       shapes_only: bool = False) -> dict:
    """Dotted ``state_dict`` keys → a nested flax-layout tree of numpy
    arrays: ``weight`` → ``kernel`` (OIHW → HWIO, ``[out, in]`` →
    ``[in, out]``), other leaves as they are.  ``shapes_only``: each leaf
    is a zero-strided fp32 array of the leaf's shape (no copy; the tensors
    may be on the ``meta`` device)."""
    out: dict = {}
    for key, t in sd.items():
        *path, name = key.split(".")
        if shapes_only:
            a = np.broadcast_to(np.float32(0), tuple(t.shape))
        else:
            a = t.detach().float().cpu().numpy()
        if name == "weight":
            name = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[name] = a if shapes_only else np.ascontiguousarray(a)
    return out


def export_jax_params(modules) -> dict:
    """The inverse of ``load_jax_params``: ``{"sr": {"params": …},
    "arcface": …, "arcface_stats": …, "mapping": {"params": …}}`` as
    numpy, the JAX package's joint layout."""
    af = modules.arcface
    return {
        "sr": {"params": state_dict_to_flax(dict(
            modules.unet.named_parameters()))},
        "arcface": state_dict_to_flax(dict(af.named_parameters())),
        "arcface_stats": state_dict_to_flax(dict(af.named_buffers())),
        "mapping": {"params": state_dict_to_flax(dict(
            modules.mapping.named_parameters()))},
    }
