"""Reference PyTorch checkpoints → the JAX package's parameter trees, in
numpy, without JAX.

The port's copy of ``sr3d_tpu/utils/convert.py``: ``convert_sr3_unet``,
``convert_arcface``, ``convert_mapping`` and their helpers walk a
reference ``state_dict`` (the SR3/DDPM UNet ``*_gen.pth``, the insightface
``backbone.pth``, the MICA MappingNetwork) into flax-layout trees of numpy
arrays, leaf for leaf as the JAX package's do.  Such a tree reaches the
port's modules through ``utils/bridge.py`` (``flax_to_state_dict``), and
the CLI writes it as the flat ``leaf_i`` ``.npz`` that
``train/checkpoint.py::load_leaves_into`` and the JAX package's loader
read.

Tensor layout rules (torch → flax):
* Conv2d weight [O, I, kh, kw]  → kernel [kh, kw, I, O]
* Linear weight [O, I]          → kernel [I, O]
* Norm weight/bias              → scale/bias
* BatchNorm running_mean/var    → batch_stats mean/var
* PReLU weight                  → alpha

All functions accept a ``state_dict``-like mapping of numpy arrays or torch
tensors.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..train.checkpoint import jax_tree_flatten


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def conv_w(t) -> np.ndarray:
    return _np(t).transpose(2, 3, 1, 0)


def linear_w(t) -> np.ndarray:
    return _np(t).T


def strip_prefix(sd: Mapping, prefix: str = "module.") -> dict:
    """Drop DataParallel prefixes (reference lib/trainer_temp.py:176-184)."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


# --------------------------------------------------------------------------
# SR3 UNet
# --------------------------------------------------------------------------

def _convert_resblock(sd: Mapping, pfx: str) -> dict:
    """Reference ResnetBlock: block1/block2 (Block = norm+conv), noise_func
    (FeatureWiseAffine), res_conv."""
    out = {}
    # reference Block Sequential: GN(0), Swish(1), Dropout/Identity(2),
    # Conv(3) — unet.py:80-92; conv is always index 3
    for blk in ("block1", "block2"):
        out[blk] = {
            "norm": {"scale": _np(sd[f"{pfx}.{blk}.block.0.weight"]),
                     "bias": _np(sd[f"{pfx}.{blk}.block.0.bias"])},
            "conv": {"kernel": conv_w(sd[f"{pfx}.{blk}.block.3.weight"]),
                     "bias": _np(sd[f"{pfx}.{blk}.block.3.bias"])},
        }
    nf = f"{pfx}.noise_func.noise_func.0"
    if f"{nf}.weight" in sd:
        out["noise_func"] = {"noise_func": {
            "kernel": linear_w(sd[f"{nf}.weight"]),
            "bias": _np(sd[f"{nf}.bias"])}}
    rc = f"{pfx}.res_conv"
    if f"{rc}.weight" in sd:
        out["res_conv"] = {"kernel": conv_w(sd[f"{rc}.weight"]),
                           "bias": _np(sd[f"{rc}.bias"])}
    return out


def _convert_attn(sd: Mapping, pfx: str) -> dict:
    return {
        "norm": {"scale": _np(sd[f"{pfx}.norm.weight"]),
                 "bias": _np(sd[f"{pfx}.norm.bias"])},
        "qkv": {"kernel": conv_w(sd[f"{pfx}.qkv.weight"])},
        "out": {"kernel": conv_w(sd[f"{pfx}.out.weight"]),
                "bias": _np(sd[f"{pfx}.out.bias"])},
    }


def convert_sr3_unet(
    state_dict: Mapping,
    channel_mults=(1, 2, 4, 8, 8),
    res_blocks: int = 2,
    attn_res=(16,),
    image_size: int = 128,
) -> dict:
    """Reference UNet state dict → flax ``{"params": ...}`` for SR3UNet.

    The torch module is flat ModuleLists (``downs.N`` / ``mid.N`` /
    ``ups.N``); this walks them in the same construction order as
    SR3UNet.__call__ to recover the named mapping.  Attention placement is
    detected from the checkpoint's own keys, so ``attn_res``/``image_size``
    only need to describe the block/mult structure, not the attention
    topology (reference checkpoints may be attn@16 or the experiments'
    effective mid-only layout).
    """
    sd = strip_prefix(dict(state_dict))
    params: dict = {}

    # noise_level_mlp: Sequential(PositionalEncoding, Linear, Swish, Linear)
    if "noise_level_mlp.1.weight" in sd:
        params["noise_level_mlp"] = {
            "dense0": {"kernel": linear_w(sd["noise_level_mlp.1.weight"]),
                       "bias": _np(sd["noise_level_mlp.1.bias"])},
            "dense1": {"kernel": linear_w(sd["noise_level_mlp.3.weight"]),
                       "bias": _np(sd["noise_level_mlp.3.bias"])},
        }

    def res_with_attn(pfx, has_attn):
        # trust the CHECKPOINT over the expected topology: the torch
        # ResnetBlocWithAttn only materialises `.attn` when with_attn was
        # set at construction, so key presence is exact.  This matters
        # because the reference experiments' effective topology is
        # mid-attention-only (the image_size=224 gate quirk, see
        # tools/mirror_configs.py) while the SR-only pretrained lineage
        # may carry attn@16 — both convert correctly without the caller
        # knowing which it has.
        has_attn = f"{pfx}.attn.norm.weight" in sd
        node = {"res_block": _convert_resblock(sd, f"{pfx}.res_block")}
        if has_attn:
            node["attn"] = _convert_attn(sd, f"{pfx}.attn")
        return node

    # encoder
    params["conv_in"] = {"kernel": conv_w(sd["downs.0.weight"]),
                         "bias": _np(sd["downs.0.bias"])}
    idx = 1
    now_res = image_size
    num_mults = len(channel_mults)
    for ind in range(num_mults):
        is_last = ind == num_mults - 1
        use_attn = now_res in set(attn_res)
        for b in range(res_blocks):
            params[f"down_{ind}_{b}"] = res_with_attn(f"downs.{idx}",
                                                      use_attn)
            idx += 1
        if not is_last:
            params[f"downsample_{ind}"] = {"conv": {
                "kernel": conv_w(sd[f"downs.{idx}.conv.weight"]),
                "bias": _np(sd[f"downs.{idx}.conv.bias"])}}
            idx += 1
            now_res //= 2

    params["mid_0"] = res_with_attn("mid.0", True)
    params["mid_1"] = res_with_attn("mid.1", False)

    idx = 0
    for ind in reversed(range(num_mults)):
        is_last = ind < 1
        use_attn = now_res in set(attn_res)
        for b in range(res_blocks + 1):
            params[f"up_{ind}_{b}"] = res_with_attn(f"ups.{idx}", use_attn)
            idx += 1
        if not is_last:
            params[f"upsample_{ind}"] = {"conv": {
                "kernel": conv_w(sd[f"ups.{idx}.conv.weight"]),
                "bias": _np(sd[f"ups.{idx}.conv.bias"])}}
            idx += 1
            now_res *= 2

    # final Block
    params["final_conv"] = {
        "norm": {"scale": _np(sd["final_conv.block.0.weight"]),
                 "bias": _np(sd["final_conv.block.0.bias"])},
        "conv": {"kernel": conv_w(sd["final_conv.block.3.weight"]),
                 "bias": _np(sd["final_conv.block.3.bias"])},
    }
    return {"params": params}


# --------------------------------------------------------------------------
# ArcFace iResNet
# --------------------------------------------------------------------------

def _bn(sd, pfx):
    return (
        {"scale": _np(sd[f"{pfx}.weight"]), "bias": _np(sd[f"{pfx}.bias"])},
        {"mean": _np(sd[f"{pfx}.running_mean"]),
         "var": _np(sd[f"{pfx}.running_var"])},
    )


def convert_arcface(state_dict: Mapping,
                    layers=(3, 13, 30, 3)) -> dict:
    """insightface ``backbone.pth`` → flax variables {params, batch_stats}
    for IResNet."""
    sd = strip_prefix(dict(state_dict))
    params: dict = {}
    stats: dict = {}

    params["conv1"] = {"kernel": conv_w(sd["conv1.weight"])}
    p, s = _bn(sd, "bn1")
    params["bn1"], stats["bn1"] = p, s
    params["prelu"] = {"alpha": _np(sd["prelu.weight"])}

    for li, nblocks in enumerate(layers, start=1):
        lp: dict = {}
        ls: dict = {}
        for bi in range(nblocks):
            t = f"layer{li}.{bi}"
            bp: dict = {}
            bs: dict = {}
            for bn_name in ("bn1", "bn2", "bn3"):
                p, s = _bn(sd, f"{t}.{bn_name}")
                bp[bn_name], bs[bn_name] = p, s
            bp["conv1"] = {"kernel": conv_w(sd[f"{t}.conv1.weight"])}
            bp["conv2"] = {"kernel": conv_w(sd[f"{t}.conv2.weight"])}
            bp["prelu"] = {"alpha": _np(sd[f"{t}.prelu.weight"])}
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {
                    "kernel": conv_w(sd[f"{t}.downsample.0.weight"])}
                p, s = _bn(sd, f"{t}.downsample.1")
                bp["downsample_bn"], bs["downsample_bn"] = p, s
            lp[f"block{bi}"] = bp
            ls[f"block{bi}"] = bs
        params[f"layer{li}"] = lp
        stats[f"layer{li}"] = ls

    p, s = _bn(sd, "bn2")
    params["bn2"], stats["bn2"] = p, s
    # torch flattens NCHW (channel-major); the flax model flattens NHWC —
    # permute the fc input features [out, C,7,7] → [out, 7,7,C]
    fc_w = _np(sd["fc.weight"])
    out_f = fc_w.shape[0]
    c_in = fc_w.shape[1] // 49
    fc_w = fc_w.reshape(out_f, c_in, 7, 7).transpose(0, 2, 3, 1)
    params["fc"] = {"kernel": fc_w.reshape(out_f, -1).T,
                    "bias": _np(sd["fc.bias"])}
    # "features" BatchNorm1d: affine weight pinned (use_scale=False)
    stats["features"] = {"mean": _np(sd["features.running_mean"]),
                         "var": _np(sd["features.running_var"])}
    params["features"] = {"bias": _np(sd["features.bias"])}
    return {"params": params, "batch_stats": stats}


def convert_mapping(state_dict: Mapping, hidden: int = 3) -> dict:
    """Reference MappingNetwork (ModuleList ``network`` of 1+hidden Linears
    + ``output`` Linear, model/mica/generator.py:40-47) → flax params."""
    sd = strip_prefix(dict(state_dict))
    params: dict = {}
    for i in range(1 + hidden):
        params[f"dense{i}"] = {
            "kernel": linear_w(sd[f"network.{i}.weight"]),
            "bias": _np(sd[f"network.{i}.bias"])}
    params["output"] = {"kernel": linear_w(sd["output.weight"]),
                        "bias": _np(sd["output.bias"])}
    return {"params": params}


def main(argv=None) -> int:
    """CLI: convert a reference torch checkpoint to a ``.npz`` of flax
    leaves in ``jax.tree_util``'s order.

    ``python -m sr3d_torch.utils.convert --kind {sr3_unet,arcface,mapping}
    --in <file.pth> --out <file.npz>``

    Besides the ``leaf_i`` arrays the file carries a ``treedef`` string:
    the JAX package writes JAX's own treedef repr there, which the port
    cannot produce, so it writes a description of the tree instead (no
    loader reads the entry)."""
    import argparse

    import torch

    p = argparse.ArgumentParser(description="torch → flax-layout numpy "
                                            "weight conversion")
    p.add_argument("--kind", required=True,
                   choices=["sr3_unet", "arcface", "mapping"])
    p.add_argument("--in", dest="inp", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--channel-mults", default="1,2,4,8,8")
    p.add_argument("--res-blocks", type=int, default=2)
    p.add_argument("--image-size", type=int, default=128,
                   help="block/mult structure only — attention placement "
                        "is auto-detected from the checkpoint's keys")
    args = p.parse_args(argv)

    sd = torch.load(args.inp, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if args.kind == "sr3_unet":
        tree = convert_sr3_unet(
            sd, channel_mults=tuple(
                int(x) for x in args.channel_mults.split(",")),
            res_blocks=args.res_blocks, image_size=args.image_size)
    elif args.kind == "arcface":
        tree = convert_arcface(sd)
    else:
        tree = convert_mapping(sd)

    leaves, _ = jax_tree_flatten(tree)
    desc = (f"sr3d_torch.utils.convert {args.kind}: {len(leaves)} leaves "
            f"in jax.tree_util order, top-level keys {sorted(tree)}")
    np.savez(args.out, treedef=desc,
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    print(f"converted {args.kind}: {len(leaves)} arrays -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
