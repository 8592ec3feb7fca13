"""The port's real-asset bootstrap (``utils/bootstrap.py``) held against
the JAX package's on the CPU, on fabricated reference-layout asset trees
(no download): an insightface-layout ``backbone.pth``, an SR3 ``_gen.pth``
+ ``_opt.pth`` pair with attention at 16² and one with attention in the
middle block only, a MICA ``.tar``, and FLAME files from
``write_reference_format_assets``.  The trees come from seeded port
modules through ``chip_smoke.py``'s ``reference_*_sd`` (the inverse of
``utils/convert.py``'s maps, checked here by a round trip).  Every
converted ``.npz`` is leaf for leaf the JAX bootstrap's, the manifests
are equal apart from paths and output hashes, ``--check`` fails after one
flipped byte, and the files load into the port's modules."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from sr3d_torch.models.arcface import IResNet
from sr3d_torch.models.mapping import MappingNetwork
from sr3d_torch.models.sr3_unet import SR3UNet
from sr3d_torch.train import checkpoint as tc
from sr3d_torch.utils import bootstrap as tb
from sr3d_torch.utils import convert as tconv
from sr3d_torch.utils.bridge import state_dict_to_flax
from sr3d_tpu.utils import bootstrap as jb

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
UNET = dict(in_channel=6, out_channel=3, inner_channel=16, norm_groups=8,
            channel_mults=(1, 2), res_blocks=1, image_size=16,
            dtype=torch.float32)
ARGS = ["--arcface-layers", "1,1,1,1", "--image-size", "16",
        "--norm-groups", "8", "--attn-res", "16", "--n-shape", "8"]


def _randomized(net, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in [*net.named_parameters(), *net.named_buffers()]:
            t.copy_(torch.rand(t.shape, generator=g) + 0.5
                    if name.endswith("var")
                    else torch.randn(t.shape, generator=g) * 0.1)
    return net


@pytest.fixture(scope="module")
def nets():
    return {"arcface": _randomized(IResNet(layers=(1, 1, 1, 1),
                                           dtype=torch.float32), 0),
            "unet_attn16": _randomized(SR3UNet(attn_res=(16,), **UNET), 1),
            "unet_mid": _randomized(SR3UNet(attn_res=(-1,), **UNET), 2),
            "mapping": _randomized(MappingNetwork(512, 32, 16, 3), 3)}


@pytest.fixture(scope="module")
def trees(tmp_path_factory, nets):
    """Two asset trees: everything with the attention-at-16² UNet; the
    mid-attention-only UNet's pair alone."""
    full = tmp_path_factory.mktemp("assets_full")
    chip_smoke.write_reference_assets(full, nets["unet_attn16"],
                                      nets["arcface"], nets["mapping"],
                                      n_vertices=48)
    mid = tmp_path_factory.mktemp("assets_mid")
    (mid / "ckpt").mkdir()
    torch.save({f"module.{k}": v for k, v in
                chip_smoke.reference_unet_sd(nets["unet_mid"]).items()},
               mid / "ckpt" / "I7_E1_gen.pth")
    torch.save({"iter": 7, "epoch": 1}, mid / "ckpt" / "I7_E1_opt.pth")
    torch.save({}, mid / "ckpt" / "I3_E0_gen.pth")   # an older iteration
    return {"full": full, "mid": mid}


@pytest.fixture(scope="module")
def converted(tmp_path_factory, trees):
    """Each package's bootstrap on each tree."""
    out = {}
    for name, root in trees.items():
        for side, mod in (("t", tb), ("j", jb)):
            d = tmp_path_factory.mktemp(f"out_{name}_{side}")
            assert mod.main(["--assets", str(root), "--out", str(d)]
                            + ARGS) == 0
            out[name, side] = d
    return out


def _leaves_equal(a, b):
    la, lb = tc.jax_tree_flatten(a), tc.jax_tree_flatten(b)
    assert la[1] == lb[1]
    for x, y in zip(la[0], lb[0], strict=True):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def test_reference_layout_round_trip(nets):
    """``chip_smoke.reference_*_sd`` invert ``utils/convert.py``: the
    converters give back the modules' own trees."""
    for key, attn in (("unet_attn16", (16,)), ("unet_mid", (-1,))):
        unet = nets[key]
        got = tconv.convert_sr3_unet(chip_smoke.reference_unet_sd(unet),
                                     channel_mults=(1, 2), res_blocks=1,
                                     attn_res=attn, image_size=16)
        _leaves_equal(got, {"params": state_dict_to_flax(
            dict(unet.named_parameters()))})
    arc = nets["arcface"]
    sd = chip_smoke.reference_arcface_sd(arc)
    assert sd["features.weight"].eq(1).all() and \
        int(sd["bn1.num_batches_tracked"]) == 0
    _leaves_equal(tconv.convert_arcface(sd, layers=(1, 1, 1, 1)), {
        "params": state_dict_to_flax(dict(arc.named_parameters())),
        "batch_stats": state_dict_to_flax(dict(arc.named_buffers()))})
    _leaves_equal(tconv.convert_mapping(
        chip_smoke.reference_mapping_sd(nets["mapping"])),
        {"params": state_dict_to_flax(dict(
            nets["mapping"].named_parameters()))})


def test_discovery_and_structure_match_jax(trees):
    for root in trees.values():
        got, want = tb.discover(root), jb.discover(root)
        assert got == want
    assert set(tb.discover(trees["full"])) == {
        "backbone", "flame_model", "lmk_embedding", "masks", "sr_gen",
        "sr_opt", "mica_ckpt"}
    assert tb.discover(trees["mid"])["sr_gen"].name == "I7_E1_gen.pth"
    for name in ("full", "mid"):
        gen = tb.discover(trees[name])["sr_gen"]
        sd = tconv.strip_prefix({k: v.numpy() for k, v in
                                 torch.load(gen).items()})
        assert tb.infer_sr3_structure(sd) == jb.infer_sr3_structure(sd)


def _manifest(out: Path) -> dict:
    text = (out / "manifest.json").read_text().replace(str(out), "OUT")
    mf = json.loads(text)
    for e in mf["artifacts"]:
        assert len(e.pop("sha256_output")) == 64
    return mf


@pytest.mark.parametrize("tree", ["full", "mid"])
def test_outputs_equal_jax_leaf_for_leaf(converted, tree):
    t, j = converted[tree, "t"], converted[tree, "j"]
    files = sorted(p.relative_to(t) for p in t.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(j) for p in j.rglob("*")
                           if p.is_file())
    for rel in files:
        if rel.suffix != ".npz":
            if rel.name != "manifest.json":
                assert (t / rel).read_bytes() == (j / rel).read_bytes()
            continue
        with np.load(t / rel) as a, np.load(j / rel) as b:
            assert sorted(a.files) == sorted(b.files), rel
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (rel, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=str(rel))
    got, want = _manifest(t), _manifest(j)
    assert got == want
    sr = [e for e in got["artifacts"] if e["kind"] == "sr3_unet"][0]
    assert sr["structure"]["attn_res"] == ([16] if tree == "full" else [-1])
    assert all(e["verified"] in ("structural", "loaded")
               for e in got["artifacts"])
    if tree == "full":
        assert [e["kind"] for e in got["artifacts"]] == [
            "flame/generic_model.pkl", "flame/landmark_embedding.npy",
            "flame/FLAME_masks.pkl", "arcface", "sr3_unet", "arcface",
            "mapping"]
        assert sr["opt_counters"]["iter"] == 100


def test_check_fails_after_one_flipped_byte(converted, tmp_path):
    import shutil

    out = tmp_path / "out"
    shutil.copytree(converted["full", "t"], out)
    text = (out / "manifest.json").read_text().replace(
        str(converted["full", "t"]), str(out))
    (out / "manifest.json").write_text(text)
    argv = ["--assets", str(tmp_path), "--out", str(out), "--check"]
    assert tb.main(argv) == 0 and jb.main(argv) == 0
    victim = out / "mapping.npz"
    data = bytearray(victim.read_bytes())
    data[len(data) // 3] ^= 0x01
    victim.write_bytes(bytes(data))
    assert tb.main(argv) == 1 and jb.main(argv) == 1
    victim.unlink()
    assert tb.main(argv) == 1


def test_converted_files_load_into_the_port(converted, nets):
    """``load_arcface_npz`` gives the backbone's parameters and statistics;
    ``Predictor.from_config(checkpoint=)`` the UNet's weights."""
    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.serve import Predictor

    cfg = update_cfg(get_cfg_defaults(),
                     str(REPO / "configs" / "tiny_8_16_model2.yml"))
    cfg.tpu.compute_dtype = "float32"
    cfg.sr.model.unet.attn_res = [16]
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    out = converted["full", "t"]
    p = Predictor.from_config(cfg, checkpoint=str(out / "sr_gen.npz"),
                              device="cpu")
    want = dict(nets["unet_attn16"].named_parameters())
    got = dict(p.modules.unet.named_parameters())
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    tc.load_arcface_npz(out / "arcface.npz", p.modules)
    arc = nets["arcface"]
    for a, b in ((p.modules.arcface.named_parameters(),
                  arc.named_parameters()),
                 (p.modules.arcface.named_buffers(), arc.named_buffers())):
        a, b = dict(a), dict(b)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in b)


_FAKE_ARCFACE = """
import torch
from sr3d_torch.models.arcface import IResNet as _Port
from sr3d_torch.utils.bridge import flax_to_state_dict
from sr3d_torch.utils.convert import convert_arcface


class IBasicBlock:
    pass


class IResNet(torch.nn.Module):
    def __init__(self, block, layers):
        super().__init__()
        self.layers = tuple(layers)
        self.net = _Port(layers=self.layers, dtype=torch.float32)

    def load_state_dict(self, sd):
        tree = convert_arcface(sd, layers=self.layers)
        w = flax_to_state_dict(tree["params"])
        w.update(flax_to_state_dict(tree["batch_stats"]))
        self.net.load_state_dict(w)

    def forward(self, x):
        return self.net(x)
"""

_FAKE_UNET = """
import torch
from sr3d_torch.models.sr3_unet import SR3UNet
from sr3d_torch.utils.bridge import flax_to_state_dict
from sr3d_torch.utils.convert import convert_sr3_unet


class UNet(torch.nn.Module):
    def __init__(self, in_channel, out_channel, inner_channel, norm_groups,
                 channel_mults, attn_res, res_blocks, dropout, image_size):
        super().__init__()
        self.kw = dict(channel_mults=tuple(channel_mults),
                       res_blocks=res_blocks, image_size=image_size)
        self.net = SR3UNet(in_channel, out_channel, inner_channel,
                           norm_groups, tuple(channel_mults),
                           tuple(attn_res) or (-1,), res_blocks, image_size,
                           dtype=torch.float32)

    def load_state_dict(self, sd):
        tree = convert_sr3_unet(sd, **self.kw)
        self.net.load_state_dict(flax_to_state_dict(tree))

    def forward(self, x, gamma):
        return self.net(x, gamma)
"""


def test_forward_check_path(trees, tmp_path, monkeypatch):
    """With ``SR3D_REFERENCE`` naming a reference checkout the conversions
    are run forward against its torch modules (here stand-ins with the
    reference's constructor and ``load_state_dict`` interface, so the
    errors are 0): the manifest says ``forward-parity``."""
    ref = tmp_path / "reference"
    (ref / "model" / "mica").mkdir(parents=True)
    (ref / "model" / "sr" / "sr3_modules").mkdir(parents=True)
    (ref / "model" / "mica" / "arcface.py").write_text(_FAKE_ARCFACE)
    (ref / "model" / "sr" / "sr3_modules" / "unet.py").write_text(_FAKE_UNET)
    monkeypatch.setenv("SR3D_REFERENCE", str(ref))
    out = tmp_path / "out"
    assert tb.main(["--assets", str(trees["full"]), "--out", str(out)]
                   + ARGS) == 0
    mf = json.loads((out / "manifest.json").read_text())
    checked = [e for e in mf["artifacts"]
               if e["kind"] in ("arcface", "sr3_unet")]
    assert len(checked) == 3
    for e in checked:
        assert e["verified"] == "forward-parity" and e["max_abs_err"] == 0.0
    assert tb.main(["--assets", str(trees["full"]), "--out",
                    str(tmp_path / "out2"), "--no-verify"] + ARGS) == 0
    mf = json.loads((tmp_path / "out2" / "manifest.json").read_text())
    assert all(e["verified"] != "forward-parity" for e in mf["artifacts"])
