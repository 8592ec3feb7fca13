"""One-command real-asset bootstrap: discover → convert → verify → manifest.

The port's copy of ``sr3d_tpu/utils/bootstrap.py``.  The reference's
operational path depends on three artifact families that cannot ship with
the repo:

* insightface ArcFace ``backbone.pth``;
* FLAME2020 ``generic_model.pkl`` + ``landmark_embedding.npy`` +
  ``FLAME_masks.pkl``;
* pretrained SR3 checkpoints ``I{iter}_E{epoch}_gen.pth`` [+ ``_opt.pth``]
  and/or a combined MICA ``*.tar`` (``{'arcface': ..., 'flameModel':
  ...}``).

``python -m sr3d_torch.utils.bootstrap --assets <dir> --out <dir>`` walks
the assets directory, converts every artifact it recognises with the key
maps of ``utils/convert.py`` into the flat ``leaf_i`` ``.npz`` files that
``train/checkpoint.py::load_leaves_into`` / ``load_arcface_npz`` and
``serve.Predictor.from_config(checkpoint=)`` read (the JAX package's
loaders too: the same leaves, in ``jax.tree_util``'s order), verifies each
conversion, installs the FLAME pickles, and writes a ``manifest.json`` with
the sha256 of every input and output (``--check`` re-hashes the outputs
of an existing manifest).  It ends by printing the config overrides that
point a run at the converted set.

Verification: structural, against the leaf names and shapes of the port's
own modules (built on the ``meta`` device, exported to the JAX layout by
``utils/bridge.py``; no weights are made); and, where the environment
variable ``SR3D_REFERENCE`` names a checkout of the reference repository,
a forward pass of the reference's torch modules against the port's
modules in fp32 on the CPU.  Conversion is host work: the bootstrap uses
no GPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..train.checkpoint import jax_tree_flatten
from .bridge import flax_to_state_dict, state_dict_to_flax


# --------------------------------------------------------------------------
# small utilities
# --------------------------------------------------------------------------

def sha256_file(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _treedef_repr(tree: Any) -> str:
    """``repr(jax.tree_util.tree_structure(tree))`` of a tree of nested
    dicts: the ``treedef`` entry the JAX package writes beside the
    leaves."""
    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _save_leaf_npz(out: Path, tree: Any) -> int:
    """Write a tree as the flat ``leaf_i`` npz format every loader in
    train/checkpoint.py consumes."""
    leaves, _ = jax_tree_flatten(tree)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, treedef=_treedef_repr(tree),
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    return len(leaves)


def _leaf_paths(tree: Any, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _structural_check(tree: Any, template: Any, what: str) -> None:
    """The converted tree must have the module's own structure and
    shapes."""
    got, got_def = jax_tree_flatten(tree)
    want, want_def = jax_tree_flatten(template)
    if got_def != want_def:
        a, b = set(_leaf_paths(tree)), set(_leaf_paths(template))
        raise ValueError(f"{what}: converted tree structure does not match "
                         f"the model (only in the checkpoint: "
                         f"{sorted(a - b)[:8]}; only in the model: "
                         f"{sorted(b - a)[:8]})")
    for i, (a, b) in enumerate(zip(got, want)):
        if np.shape(a) != np.shape(b):
            raise ValueError(f"{what}: leaf {i} shape {np.shape(a)} != "
                             f"model's {np.shape(b)}")


def _arcface_template(layers) -> dict:
    """``{"batch_stats", "params"}`` of an fp32 IResNet, shapes only."""
    from ..models.arcface import IResNet

    with torch.device("meta"):
        net = IResNet(layers=tuple(layers), dtype=torch.float32)
    return {"batch_stats": state_dict_to_flax(dict(net.named_buffers()),
                                              shapes_only=True),
            "params": state_dict_to_flax(dict(net.named_parameters()),
                                         shapes_only=True)}


def _sr3_template(kw: dict) -> dict:
    """``{"params"}`` of the SR3 UNet ``kw`` builds, shapes only."""
    from ..models.sr3_unet import SR3UNet

    with torch.device("meta"):
        net = SR3UNet(**kw)
    return {"params": state_dict_to_flax(dict(net.named_parameters()),
                                         shapes_only=True)}


def reference_root() -> Path | None:
    """The reference checkout the forward checks import from
    (``SR3D_REFERENCE``), or None."""
    root = os.environ.get("SR3D_REFERENCE")
    return Path(root) if root else None


def load_reference_module(relpath: str, name: str):
    """Import a reference torch module file in isolation (loguru
    stubbed)."""
    import importlib.util
    import types

    if "loguru" not in sys.modules:
        stub = types.ModuleType("loguru")
        stub.logger = types.SimpleNamespace(
            info=lambda *a, **k: None, warning=lambda *a, **k: None,
            error=lambda *a, **k: None)
        sys.modules["loguru"] = stub
    spec = importlib.util.spec_from_file_location(
        name, str(reference_root() / relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_and_ref_available() -> bool:
    root = reference_root()
    return root is not None and root.is_dir()


def _load_torch(path: Path):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # older checkpoints pickle non-tensor objects (optimizer wrappers,
        # argparse namespaces); these are the user's own trusted assets
        return torch.load(path, map_location="cpu", weights_only=False)


# --------------------------------------------------------------------------
# discovery
# --------------------------------------------------------------------------

def discover(root: Path) -> dict[str, Any]:
    """Recursively find every recognised artifact under ``root``.

    Returns a dict with any of: ``backbone``, ``flame_model``,
    ``lmk_embedding``, ``masks``, ``sr_gen`` (+ ``sr_opt`` when the pair
    file exists), ``mica_ckpt``.
    """
    found: dict[str, Any] = {}

    def first(pattern: str) -> Path | None:
        hits = sorted(root.rglob(pattern))
        return hits[0] if hits else None

    if (p := first("backbone.pth")) is not None:
        found["backbone"] = p
    if (p := first("generic_model.pkl")) is not None:
        found["flame_model"] = p
    if (p := first("landmark_embedding.npy")) is not None:
        found["lmk_embedding"] = p
    if (p := first("FLAME_masks.pkl")) is not None:
        found["masks"] = p

    gens = sorted(root.rglob("*_gen.pth"))
    if gens:
        # prefer the largest iteration count when several are present
        def iter_of(p: Path) -> int:
            stem = p.name[: -len("_gen.pth")]
            if stem.startswith("I") and "_E" in stem:
                try:
                    return int(stem[1:].split("_E")[0])
                except ValueError:
                    return -1
            return -1

        gen = max(gens, key=iter_of)
        found["sr_gen"] = gen
        opt = gen.parent / gen.name.replace("_gen.pth", "_opt.pth")
        if opt.exists():
            found["sr_opt"] = opt

    tars = [p for p in sorted(root.rglob("*.tar"))
            if "mica" in p.name.lower() or "model" in p.name.lower()]
    if tars:
        found["mica_ckpt"] = tars[0]
    return found


# --------------------------------------------------------------------------
# converters (each returns a manifest entry)
# --------------------------------------------------------------------------

def convert_backbone(pth: Path, out: Path, layers=(3, 13, 30, 3),
                     verify: bool = True) -> dict:
    """backbone.pth → ``arcface.npz`` for ``load_arcface_npz``."""
    from .convert import convert_arcface

    sd = _load_torch(pth)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    tree = convert_arcface(sd, layers=layers)
    _structural_check(tree, _arcface_template(layers), "arcface")
    # load_arcface_npz flattens {batch_stats, params}; keep that key order
    n = _save_leaf_npz(out, {"batch_stats": tree["batch_stats"],
                             "params": tree["params"]})

    entry = {"kind": "arcface", "source": str(pth),
             "sha256_source": sha256_file(pth), "output": str(out),
             "sha256_output": sha256_file(out), "leaves": n,
             "verified": "structural"}
    if verify and _torch_and_ref_available():
        entry["max_abs_err"] = _verify_arcface(sd, tree, layers)
        entry["verified"] = "forward-parity"
    return entry


def _verify_arcface(sd, tree, layers) -> float:
    from ..models.arcface import IResNet

    ref_mod = load_reference_module("model/mica/arcface.py", "bs_ref_arcface")
    ref = ref_mod.IResNet(ref_mod.IBasicBlock, list(layers)).eval().float()
    ref.load_state_dict({k: torch.as_tensor(np.asarray(v))
                         for k, v in sd.items()})
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        rng.randn(2, 112, 112, 3).astype(np.float32) * 0.5
    ).permute(0, 3, 1, 2).contiguous()
    net = IResNet(layers=tuple(layers), dtype=torch.float32).eval()
    weights = flax_to_state_dict(tree["params"])
    weights.update(flax_to_state_dict(tree["batch_stats"]))
    net.load_state_dict(weights)
    with torch.no_grad():
        err = float((net(x) - ref(x)).abs().max())
    if err > 5e-2:
        raise ValueError(f"arcface forward parity failed: max|Δ|={err:.2e}")
    return err


def infer_sr3_structure(sd) -> dict:
    """Recover (inner_channel, in_channel, out_channel, channel_mults,
    res_blocks) from a reference UNet state dict's own keys — the caller
    does not need to know which experiment produced the checkpoint.

    The torch module is flat ModuleLists: ``downs.0`` is the stem conv,
    then per stage ``res_blocks`` ResnetBlocWithAttn followed by a
    Downsample (``downs.N.conv.weight``) for every non-final stage.
    """
    w0 = np.asarray(sd["downs.0.weight"])
    inner, in_ch = int(w0.shape[0]), int(w0.shape[1])
    out_ch = int(np.asarray(sd["final_conv.block.3.weight"]).shape[0])

    # walk the downs list: stage channel = each resblock's block2 conv out
    stage_channels: list[list[int]] = [[]]
    i = 1
    while f"downs.{i}.res_block.block2.block.3.weight" in sd or \
            f"downs.{i}.conv.weight" in sd:
        if f"downs.{i}.conv.weight" in sd:  # Downsample → next stage
            stage_channels.append([])
        else:
            c = int(np.asarray(
                sd[f"downs.{i}.res_block.block2.block.3.weight"]).shape[0])
            stage_channels[-1].append(c)
        i += 1
    mults = tuple(ch[0] // inner for ch in stage_channels)
    res_blocks = len(stage_channels[0])
    return dict(inner_channel=inner, in_channel=in_ch, out_channel=out_ch,
                channel_mults=mults, res_blocks=res_blocks)


def convert_sr_checkpoint(gen: Path, out: Path, image_size: int = 128,
                          norm_groups: int = 32, attn_res=(16,),
                          verify: bool = True,
                          opt: Path | None = None,
                          out_opt: Path | None = None) -> dict:
    """``I*_E*_gen.pth`` → ``sr_gen.npz`` (the flat leaf npz that
    ``Predictor.from_config(checkpoint=)`` and the trainers' ``-ckt`` /
    ``sr.pretrained_model_path`` load)."""
    from .convert import convert_sr3_unet, strip_prefix

    sd = _load_torch(gen)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = strip_prefix({k: np.asarray(v.detach().cpu().numpy()
                                     if hasattr(v, "detach") else v)
                       for k, v in sd.items()})
    struct = infer_sr3_structure(sd)
    tree = convert_sr3_unet(sd, channel_mults=struct["channel_mults"],
                            res_blocks=struct["res_blocks"],
                            attn_res=attn_res, image_size=image_size)

    # the attention topology comes from the checkpoint itself: build the
    # module with attention at 16² only where the keys carry it
    has_attn16 = any(".attn." in k for k in sd if k.startswith("downs."))
    kw = dict(struct, norm_groups=norm_groups, image_size=image_size,
              attn_res=tuple(attn_res) if has_attn16 else (-1,),
              dropout=0.0, dtype=torch.float32)
    _structural_check(tree, _sr3_template(kw), "sr3_unet")
    n = _save_leaf_npz(out, tree)

    # the manifest's structure carries everything needed to rebuild the
    # module the npz was checked against, the resolved attention topology
    # (attn_res=(-1,) for mid-only checkpoints) and norm_groups included
    manifest_struct = {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in kw.items() if k != "dtype"}
    entry = {"kind": "sr3_unet", "source": str(gen),
             "sha256_source": sha256_file(gen), "output": str(out),
             "sha256_output": sha256_file(out), "leaves": n,
             "structure": manifest_struct,
             "verified": "structural"}
    if verify and _torch_and_ref_available():
        entry["max_abs_err"] = _verify_sr3(sd, tree, kw, image_size)
        entry["verified"] = "forward-parity"

    if opt is not None and out_opt is not None:
        # the pair's optimizer is torch Adam state, which the trainers do
        # not read (their moments transfer only from an SR-only npz pair):
        # carry the counters alone
        raw = _load_torch(opt)
        np.savez(out_opt, iter=int(raw.get("iter", 0)),
                 epoch=int(raw.get("epoch", 0)))
        entry["opt_counters"] = {"source": str(opt),
                                 "iter": int(raw.get("iter", 0)),
                                 "epoch": int(raw.get("epoch", 0)),
                                 "output": str(out_opt)}
    return entry


def _verify_sr3(sd, tree, kw, image_size) -> float:
    from ..models.sr3_unet import SR3UNet

    ref_mod = load_reference_module("model/sr/sr3_modules/unet.py",
                                    "bs_ref_unet")
    attn = [] if kw["attn_res"] == (-1,) else list(kw["attn_res"])
    ref = ref_mod.UNet(
        in_channel=kw["in_channel"], out_channel=kw["out_channel"],
        inner_channel=kw["inner_channel"], norm_groups=kw["norm_groups"],
        channel_mults=list(kw["channel_mults"]), attn_res=attn,
        res_blocks=kw["res_blocks"], dropout=0.0,
        image_size=image_size).eval()
    ref.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    # a reduced spatial size: the attention placement depends only on the
    # checkpoint's keys, and 64² keeps a full-size check cheap
    s = min(image_size, 64)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, s, s, kw["in_channel"]).astype(
        np.float32)).permute(0, 3, 1, 2).contiguous()
    gamma = torch.tensor([[0.41]])
    net = SR3UNet(**kw).eval()
    net.load_state_dict(flax_to_state_dict(tree))
    with torch.no_grad():
        err = float((net(x, gamma) - ref(x, gamma)).abs().max())
    if err > 5e-3:
        raise ValueError(f"sr3_unet forward parity failed: max|Δ|={err:.2e}")
    return err


def convert_mica_checkpoint(tar: Path, out_arcface: Path, out_mapping: Path,
                            layers=(3, 13, 30, 3), hidden: int = 3,
                            verify: bool = True) -> list[dict]:
    """Combined MICA ``*.tar`` (``{'arcface', 'flameModel'}``) → arcface
    npz + mapping npz."""
    from .convert import convert_mapping, strip_prefix

    ckpt = _load_torch(tar)
    entries: list[dict] = []
    if "arcface" in ckpt:
        import tempfile

        # route through convert_backbone for the structural/parity checks
        with tempfile.TemporaryDirectory() as td:
            tmp = Path(td) / "backbone.pth"
            torch.save(ckpt["arcface"], tmp)
            e = convert_backbone(tmp, out_arcface, layers=layers,
                                 verify=verify)
            e["source"] = f"{tar}::arcface"
            e["sha256_source"] = sha256_file(tar)
            entries.append(e)
    if "flameModel" in ckpt:
        fm = strip_prefix(dict(ckpt["flameModel"]))
        reg = {k[len("regressor."):]: v for k, v in fm.items()
               if k.startswith("regressor.")}
        tree = convert_mapping(reg, hidden=hidden)
        n = _save_leaf_npz(out_mapping, tree)
        entries.append({"kind": "mapping", "source": f"{tar}::flameModel",
                        "sha256_source": sha256_file(tar),
                        "output": str(out_mapping),
                        "sha256_output": sha256_file(out_mapping),
                        "leaves": n, "verified": "structural"})
    if not entries:
        raise ValueError(f"{tar}: no 'arcface'/'flameModel' keys — not a "
                         f"MICA combined checkpoint")
    return entries


def install_flame(flame_model: Path, lmk_embedding: Path,
                  masks: Path | None, outdir: Path,
                  n_shape: int = 300) -> list[dict]:
    """Validate the FLAME2020 pickles by fully loading them (the code path
    the trainers use), then install them under ``<out>/FLAME2020/``."""
    from ..models.flame import load_flame
    from ..models.masking import load_masks

    fm = load_flame(str(flame_model), str(lmk_embedding), n_shape=n_shape)
    dest = outdir / "FLAME2020"
    dest.mkdir(parents=True, exist_ok=True)
    entries = []
    for src, name, info in [
        (flame_model, "generic_model.pkl",
         {"n_vertices": fm.n_vertices, "n_faces": int(fm.faces.shape[0]),
          "n_shape": fm.n_shape, "n_exp": fm.n_exp}),
        (lmk_embedding, "landmark_embedding.npy",
         {"static_lmks": int(fm.lmk_faces_idx.shape[0]),
          "full_lmks": int(fm.full_lmk_faces_idx.shape[0])}),
    ]:
        out = dest / name
        if src.resolve() != out.resolve():
            shutil.copy2(src, out)
        entries.append({"kind": f"flame/{name}", "source": str(src),
                        "sha256_source": sha256_file(src),
                        "output": str(out), "sha256_output": sha256_file(out),
                        "verified": "loaded", **info})
    if masks is not None:
        md = load_masks(str(masks))
        out = dest / "FLAME_masks.pkl"
        if masks.resolve() != out.resolve():
            shutil.copy2(masks, out)
        entries.append({"kind": "flame/FLAME_masks.pkl",
                        "source": str(masks),
                        "sha256_source": sha256_file(masks),
                        "output": str(out), "sha256_output": sha256_file(out),
                        "regions": len(md), "verified": "loaded"})
    return entries


# --------------------------------------------------------------------------
# manifest re-validation
# --------------------------------------------------------------------------

def check_manifest(out: Path) -> bool:
    """Re-hash every output in an existing manifest (``--check``)."""
    mf = out / "manifest.json"
    entries = json.loads(mf.read_text())["artifacts"]
    ok = True
    for e in entries:
        p = Path(e["output"])
        if not p.exists():
            print(f"MISSING  {p}")
            ok = False
        elif sha256_file(p) != e["sha256_output"]:
            print(f"CORRUPT  {p} (sha256 mismatch)")
            ok = False
        else:
            print(f"ok       {p}")
    return ok


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _config_snippet(out: Path, found: dict, entries: list[dict]) -> str:
    # first entry per kind wins: main() converts backbone.pth before the
    # MICA-tar fallback, so with both present the snippet points at
    # arcface.npz (insightface's original backbone), not
    # arcface_from_tar.npz
    outs = {}
    for e in entries:
        outs.setdefault(e["kind"], e["output"])
    model_lines = []
    if any(k.startswith("flame/") for k in outs):
        model_lines += [
            f"    flame_model_path: {out}/FLAME2020/generic_model.pkl",
            f"    flame_lmk_embedding_path: "
            f"{out}/FLAME2020/landmark_embedding.npy",
        ]
        if "flame/FLAME_masks.pkl" in outs:
            model_lines.append(
                f"    masks_path: {out}/FLAME2020/FLAME_masks.pkl")
    if "arcface" in outs:
        model_lines.append(
            f"    arcface_pretrained_model: {outs['arcface']}")
    lines = ["# point a config at the converted set (see configs/*.yml):"]
    if model_lines or "mapping" in outs:
        lines.append("mica:")
        if model_lines:
            lines += ["  model:"] + model_lines
        if "mapping" in outs:
            lines.append(f"  pretrained_model_path: {outs['mapping']}")
    if "sr3_unet" in outs:
        lines += ["sr:", f"  pretrained_model_path: {outs['sr3_unet']}"]
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Convert + verify the reference's pretrained assets "
                    "(backbone.pth, FLAME2020, SR3/MICA checkpoints) into "
                    "the flat leaf .npz files sr3d_torch loads, in one pass")
    p.add_argument("--assets", required=True,
                   help="directory to search recursively for artifacts")
    p.add_argument("--out", default="assets_tpu")
    p.add_argument("--image-size", type=int, default=128,
                   help="SR HR resolution (structure is otherwise inferred "
                        "from the checkpoint itself)")
    p.add_argument("--norm-groups", type=int, default=32)
    p.add_argument("--attn-res", default="16")
    p.add_argument("--n-shape", type=int, default=300)
    p.add_argument("--mapping-hidden", type=int, default=3)
    p.add_argument("--arcface-layers", default="3,13,30,3",
                   help="iresnet block counts (insightface r100 default)")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the forward check against the reference's "
                        "torch modules (structural checks only)")
    p.add_argument("--check", action="store_true",
                   help="re-validate an existing --out manifest and exit")
    args = p.parse_args(argv)

    out = Path(args.out)
    if args.check:
        return 0 if check_manifest(out) else 1

    root = Path(args.assets)
    if not root.is_dir():
        p.error(f"--assets {root}: not a directory")
    found = discover(root)
    if not found:
        print(f"no recognised artifacts under {root} (expected any of: "
              f"backbone.pth, generic_model.pkl, landmark_embedding.npy, "
              f"FLAME_masks.pkl, *_gen.pth, mica *.tar)")
        return 1
    print("discovered:", {k: str(v) for k, v in found.items()})
    verify = not args.no_verify
    layers = tuple(int(x) for x in args.arcface_layers.split(","))
    entries: list[dict] = []

    if "flame_model" in found and "lmk_embedding" in found:
        entries += install_flame(found["flame_model"],
                                 found["lmk_embedding"], found.get("masks"),
                                 out, n_shape=args.n_shape)
    elif "flame_model" in found or "lmk_embedding" in found:
        print("WARNING: FLAME needs BOTH generic_model.pkl and "
              "landmark_embedding.npy — skipping partial set")

    if "backbone" in found:
        entries.append(convert_backbone(found["backbone"],
                                        out / "arcface.npz", layers=layers,
                                        verify=verify))
    if "sr_gen" in found:
        entries.append(convert_sr_checkpoint(
            found["sr_gen"], out / "sr_gen.npz",
            image_size=args.image_size, norm_groups=args.norm_groups,
            attn_res=tuple(int(x) for x in args.attn_res.split(",")),
            verify=verify, opt=found.get("sr_opt"),
            out_opt=out / "sr_opt_counters.npz"))
    if "mica_ckpt" in found:
        # a combined tar also carries arcface — only use it when no
        # standalone backbone.pth was found (backbone.pth is insightface's
        # original; the tar's copy reflects whatever finetuning the run did)
        af_out = out / ("arcface.npz" if "backbone" not in found
                        else "arcface_from_tar.npz")
        entries += convert_mica_checkpoint(
            found["mica_ckpt"], af_out, out / "mapping.npz",
            layers=layers, hidden=args.mapping_hidden, verify=verify)

    manifest = {"assets_dir": str(root), "artifacts": entries}
    out.mkdir(parents=True, exist_ok=True)
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(f"\nwrote {len(entries)} artifacts + manifest.json -> {out}")
    for e in entries:
        extra = (f"  max|Δ|={e['max_abs_err']:.2e}"
                 if "max_abs_err" in e else "")
        print(f"  {e['kind']:<28} {e['verified']:<14}{extra}")
    print("\n" + _config_snippet(out, found, entries))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
