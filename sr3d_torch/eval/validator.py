"""The MICA validation pass.

Counterpart of ``sr3d_tpu/eval/validator.py`` (the reference's
``Validator``): without gradient, over each eval dataset's first items,
the masked vertex L1 of the predicted against the ground-truth FLAME
vertices, averaged over every item (not a mean of per-dataset means, which
would reweight datasets of unequal size); the 512-d ArcFace embeddings
(the identity diagnostic, not the shape code); the total fed to the
best-model tracker; a rendered grid of a few predicted meshes.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..models import masking
from ..models.flame import flame_forward

logger = logging.getLogger("sr3d_torch")


class Validator:
    """``datasets``: {name: dataset whose items hold ``arcface`` ``[K, 112,
    112, 3]`` blobs and ``flame_shape`` ``[K, n_shape]``};
    ``predict_fn(modules, state, blobs) -> (verts, code, lmk)``
    (``train.mica_only.make_mica_predict``); ``best_model`` a
    ``train.trainer.BestModel`` or None."""

    def __init__(self, modules, predict_fn, datasets: dict,
                 best_model=None, render_n: int = 4):
        self.modules = modules
        self.predict = predict_fn
        self.datasets = datasets
        self.best_model = best_model
        self.render_n = render_n

    @torch.no_grad()
    def run(self, state, max_items: int = 16) -> dict:
        """``{"loss", "per_dataset", "improved", "embeddings"[,
        "render_grid"]}`` over the first ``max_items`` items of each
        dataset."""
        from ..train.joint import encode_mica

        m = self.modules
        per_dataset, all_losses, embeddings, render = {}, [], [], []
        for name, ds in self.datasets.items():
            losses = []
            for i in range(min(len(ds), max_items)):
                item = ds[i]
                blobs = torch.as_tensor(np.asarray(item["arcface"],
                                                   np.float32)).to(m.device)
                verts, _, _ = self.predict(m, state, blobs)
                gt_shape = torch.as_tensor(np.asarray(
                    item["flame_shape"], np.float32)).to(m.device)
                gt = flame_forward(m.flame, gt_shape)[0]
                losses.append(float(masking.masked_vertex_l1(
                    verts, gt, m.vertex_weights)))
                embeddings.append(encode_mica(m, blobs).cpu().numpy())
                if len(render) < self.render_n:
                    render.append(verts[0])
            all_losses.extend(losses)
            per_dataset[name] = float(np.mean(losses)) if losses else 0.0
        total = float(np.mean(all_losses)) if all_losses else 0.0
        # BestModel returns the tags it saved (none on its first call)
        improved = bool(self.best_model(total)) if self.best_model else False
        result = {"loss": total, "per_dataset": per_dataset,
                  "improved": improved,
                  "embeddings": (np.concatenate(embeddings) if embeddings
                                 else np.zeros((0,)))}
        if render:
            try:
                from .renderer import render_meshes, visualize_grid

                imgs = render_meshes(torch.stack(render), m.flame.faces,
                                     image_size=256)
                result["render_grid"] = visualize_grid(imgs.cpu().numpy())
            except Exception:  # pragma: no cover
                logger.exception("validator render failed")
        logger.info("validator: loss %.4f (%s)%s", total,
                    ", ".join(f"{k}={v:.4f}" for k, v in per_dataset.items()),
                    " [best]" if improved else "")
        return result
