"""The port's batch-serving CLI (``python -m sr3d_torch.serve``) on the
CPU, mirroring ``tests/test_serve.py``: a directory of LR PNGs through a
checkpoint in the JAX package's ``.npz`` layout to per-face bundles, the
int8 serving defaults and their precedence, the bundle names, and the
image reading of ``data/lrhr.py``, each against the JAX package's."""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import sr3d_torch.serve as serve_mod
from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.config import update_cfg as t_update
from sr3d_torch.data import lrhr as t_lrhr
from sr3d_torch.train.checkpoint import jax_tree_flatten
from sr3d_torch.train.joint import build_joint
from sr3d_torch.utils.bridge import export_jax_params
from sr3d_tpu import serve as j_serve
from sr3d_tpu.data import lrhr as j_lrhr

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
             / "tiny_8_16_model2.yml")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny config dumped to YAML and a train state of the port's
    random weights (seed 3) in the JAX package's ``save_state_npz``
    layout: meta, step, params, ArcFace statistics, a block of stand-in
    optimizer leaves, the EMA."""
    root = tmp_path_factory.mktemp("serve_cli")
    cfg = t_update(t_defaults(), CONFIG)
    cfg.tpu.compute_dtype = "float32"
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.sr.model.diffusion.sampler_init = "marginal"
    cfg.output_dir = str(root / "out")
    cfg_file = root / "cfg.yml"
    cfg_file.write_text(cfg.dump())
    tree = export_jax_params(build_joint(cfg, device="cpu", init_seed=3))
    params = {k: tree[k] for k in ("arcface", "mapping", "sr")}
    opt = tuple(np.zeros(3, np.float32) for _ in range(5))
    leaves, _ = jax_tree_flatten(
        {"meta": {"global_step": 5, "epoch": 1},
         "state": (np.int32(5), params, tree["arcface_stats"], opt,
                   (tree["sr"], np.int32(5)))})
    ckpt = root / "best_model.npz"
    np.savez(ckpt, **{f"leaf_{i}": np.asarray(x)
                      for i, x in enumerate(leaves)})
    return cfg, cfg_file, ckpt


def _lr_dir(root, names, seed=3):
    lr_dir = root / "lr"
    lr_dir.mkdir()
    rng = np.random.RandomState(seed)
    for name in names:
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(
            lr_dir / f"{name}.png")
    return lr_dir


def test_serve_cli(setup, tmp_path):
    """``main`` on a directory of LR PNGs writes the full per-face bundle
    with the --sampler/--steps overrides at the int8 default; its SR
    images are the Predictor's for the same config; --warmup-cache is
    accepted and writes nothing."""
    cfg, cfg_file, ckpt = setup
    names = ("face_a", "face_b", "face_c")
    lr_dir = _lr_dir(tmp_path, names)
    out, cache = tmp_path / "served", tmp_path / "serve_cache"
    rc = serve_mod.main(["-c", str(cfg_file), "-ckt", str(ckpt),
                         "--input", str(lr_dir), "--out", str(out),
                         "--sampler", "dpm++", "--steps", "4", "--batch",
                         "2", "--warmup-cache", str(cache)], device="cpu")
    assert rc == 0
    assert not cache.exists()
    for name in names:
        d = out / name
        for f in ("mesh.ply", "mesh.obj", f"{name}_sr.png", "identity.npy",
                  "kpt7.npy", "kpt68.npy"):
            assert (d / f).exists(), f
    got = np.stack([np.asarray(Image.open(out / n / f"{n}_sr.png"))
                    for n in names])
    assert got.shape == (3, 16, 16, 3)
    want_cfg = serve_mod.apply_serving_flags(cfg.clone(), sampler="dpm++",
                                             steps=4)
    assert (want_cfg.sr.model.unet.quant_min_res,
            want_cfg.sr.model.unet.quant_resample) == (1, True)
    p = serve_mod.Predictor.from_config(want_cfg, checkpoint=str(ckpt),
                                        batch_size=2, device="cpu")
    imgs = np.stack([t_lrhr.load_image_m11(lr_dir / f"{n}.png")
                     for n in names])
    np.testing.assert_array_equal(p.predict(imgs)["sr_u8"], got)


def test_serve_cli_int8_default(setup, tmp_path, monkeypatch):
    """The CLI's int8 defaults and precedence, as the JAX CLI's
    (``tests/test_serve.py::test_serve_cli_int8_default``: the same
    ``seen`` list): quant_min_res 1 with resampling by default; --int8 0
    forces fp; an explicit --int8 N and a config's own quant_min_res win;
    resampling defaults on only at depth 1; --no-int8-resample opts
    out."""
    cfg, cfg_file, ckpt = setup
    lr_dir = tmp_path / "lr"
    lr_dir.mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(lr_dir / "f.png")
    seen = []

    class Stub:
        def export(self, imgs, out, names=None):
            return len(names)

    def fake_from_config(c, **kw):
        seen.append((int(c.sr.model.unet.quant_min_res),
                     bool(c.sr.model.unet.quant_resample)))
        return Stub()

    monkeypatch.setattr(serve_mod.Predictor, "from_config",
                        staticmethod(fake_from_config))
    base = ["-c", str(cfg_file), "-ckt", str(ckpt),
            "--input", str(lr_dir), "--out", str(tmp_path / "o")]
    assert serve_mod.main(base) == 0                    # default
    assert serve_mod.main(base + ["--int8", "0"]) == 0  # forced fp
    assert serve_mod.main(base + ["--int8", "128"]) == 0
    assert serve_mod.main(base + ["--int8", "128", "--int8-resample"]) == 0
    assert serve_mod.main(base + ["--no-int8-resample"]) == 0
    assert seen == [(1, True), (0, False), (128, False), (128, True),
                    (1, False)]

    cfg2 = cfg.clone()
    cfg2.sr.model.unet.quant_min_res = 64
    cfg_file2 = tmp_path / "cfg2.yml"
    cfg_file2.write_text(cfg2.dump())
    seen.clear()
    assert serve_mod.main(["-c", str(cfg_file2), "-ckt", str(ckpt),
                           "--input", str(lr_dir),
                           "--out", str(tmp_path / "o2")]) == 0
    assert seen == [(64, False)]


def test_bundle_names_dedup():
    """Duplicate stems across subdirectories disambiguate with the subdir;
    unique stems stay bare (as the JAX package's ``bundle_names``)."""
    paths = ["/in/a/face.png", "/in/b/face.png", "/in/a/other.png"]
    assert serve_mod.bundle_names(paths, "/in") == \
        j_serve.bundle_names(paths, "/in") == ["a_face", "b_face", "other"]
    assert serve_mod.bundle_names(["/in/x.png"], "/in") == ["x"]


def test_bundle_names_same_dir_extension_collision():
    """a/face.png + a/face.jpg still get distinct bundle names."""
    for paths in (["/in/a/face.png", "/in/a/face.jpg"],
                  ["/in/face.png", "/in/face.jpg", "/in/b/other.png"]):
        names = serve_mod.bundle_names(paths, "/in")
        assert names == j_serve.bundle_names(paths, "/in")
        assert len(set(names)) == len(paths)


def test_lrhr_reads_images_as_jax(tmp_path):
    """The recursive sorted scan and the [−1, 1] decode of
    ``data/lrhr.py`` equal the JAX package's, over PNG, JPEG, gray and
    RGBA files in nested directories; an empty directory and a file
    raise."""
    rng = np.random.RandomState(4)
    (tmp_path / "b" / "c").mkdir(parents=True)
    Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(
        tmp_path / "z.png")
    Image.fromarray(rng.randint(0, 255, (6, 8), np.uint8)).save(
        tmp_path / "b" / "g.png")
    Image.fromarray(rng.randint(0, 255, (8, 6, 4), np.uint8)).save(
        tmp_path / "b" / "c" / "a.PNG")
    Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(
        tmp_path / "b" / "j.jpg")
    (tmp_path / "notes.txt").write_text("x")
    paths = t_lrhr.get_paths_from_images(tmp_path)
    assert paths == j_lrhr.get_paths_from_images(tmp_path)
    assert len(paths) == 4
    for p in paths:
        np.testing.assert_array_equal(t_lrhr.load_image_m11(p),
                                      j_lrhr.load_image_m11(p))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        t_lrhr.get_paths_from_images(tmp_path / "empty")
    with pytest.raises(NotADirectoryError):
        t_lrhr.get_paths_from_images(tmp_path / "notes.txt")
