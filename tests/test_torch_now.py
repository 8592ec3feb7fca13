"""The port's NoW / Stirling tester (``eval/tester.py``) and one-command
runner (``eval/now_protocol.py``) held against the JAX package on the CPU:
the geometry (Umeyama 7-point alignment, closest point on triangles,
point-to-surface distance on both branches, scan masking) equal to the
JAX package's; the synthetic fixture file for file; ``Tester.run`` and
``run_stirling`` on the same tiny MICA weights (bridged) and the same
blobs within 1e-3 mm, the blob cache read across packages;
``evaluate_now`` identical reports; the runner's dry run and a run on a
joint checkpoint."""

import filecmp
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.eval import now_protocol as tnow
from sr3d_torch.eval import tester as tt
from sr3d_torch.train import joint as tj
from sr3d_torch.train import mica_only as tm
from sr3d_torch.utils.bridge import export_jax_params
from sr3d_tpu.config.defaults import get_cfg_defaults
from sr3d_tpu.eval import now_protocol as jnow
from sr3d_tpu.eval import tester as jt
from sr3d_tpu.models.flame import sphere_flame as j_sphere
from sr3d_tpu.train import joint as jj
from sr3d_tpu.train import mica_only as jm

torch.set_num_threads(1)

MM_TOL = 1e-3   # mm

TINY_YAML = """\
tpu: {compute_dtype: float32, sample_remat: false, train_remat: false}
sr:
  model:
    unet: {inner_channel: 16, norm_groups: 8, channel_multiplier: [1, 2],
           attn_res: [8], res_blocks: 1, dropout: 0.0}
    diffusion: {image_size: 16}
    beta_schedule:
      train: {n_timestep: 8}
      val: {n_timestep: 8}
  datasets:
    train: {l_resolution: 8, r_resolution: 16}
    val: {l_resolution: 8, r_resolution: 16}
  train: {ema_scheduler: null}
mica:
  model: {n_shape: 8, n_exp: 4, map_hidden_dim: 16, mapping_layers: 1,
          arcface_layers: [1, 1, 1, 1], synthetic_flame_kind: sphere}
"""


def tiny(cfg, tmp: Path):
    """The JAX NoW test's tiny MICA (ArcFace [1,1,1,1], one 16-wide
    mapping layer, the sphere FLAME with 8 + 4 coefficients) on a tiny
    UNet, fp32, from ``TINY_YAML``."""
    from sr3d_tpu.config.defaults import update_cfg

    path = tmp / "tiny_now.yml"
    path.write_text(TINY_YAML)
    return update_cfg(cfg, str(path)), path


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("now")


@pytest.fixture(scope="module")
def fixtures(work):
    """The synthetic NoW fixture written by each package from the same
    sphere FLAME and seed (2 subjects × 2 images at 64²)."""
    from sr3d_torch.models.flame import sphere_flame

    out = {}
    for side, mod, flame in (
            ("t", tnow, sphere_flame(n_shape=8, n_exp=4)),
            ("j", jnow, j_sphere(n_shape=8, n_exp=4))):
        out[side] = mod.generate_now_fixture(work / f"fx_{side}", flame,
                                             n_subjects=2,
                                             imgs_per_subject=2, img_res=64)
    return out


@pytest.fixture(scope="module")
def mica(work):
    """Port modules with random tiny MICA weights, the JAX modules and a
    JAX ``MicaTrainState`` holding the same weights (bridged)."""
    from sr3d_torch.config import update_cfg as t_update

    jcfg, path = tiny(get_cfg_defaults(), work)
    tcfg = t_update(t_defaults(), str(path))
    mods = tj.build_joint(tcfg, device="cpu", init_seed=3)
    # ArcFace's statistics off their 0/1 init
    rng = np.random.RandomState(7)
    for name, buf in mods.arcface.named_buffers():
        buf.copy_(torch.from_numpy(
            (rng.uniform(0.5, 1.5, buf.shape) if name.endswith("var")
             else rng.randn(*buf.shape) * 0.1).astype(np.float32)))
    tree = export_jax_params(mods)
    st = jm.MicaTrainState(step=np.int32(0),
                           params={"arcface": tree["arcface"],
                                   "mapping": tree["mapping"]},
                           arcface_stats=tree["arcface_stats"],
                           opt_state=None)
    return tcfg, mods, jj.build_joint(jcfg), st


def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.randn(7, 3) * 40
    R = np.linalg.qr(rng.randn(3, 3))[0]
    dst = 1.3 * src @ R.T + rng.randn(3) * 5 + rng.randn(7, 3) * 0.1
    for a, b in zip(tt.rigid_align_7(src, dst), jt.rigid_align_7(src, dst),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    p = rng.randn(50, 3)
    tri = rng.randn(50, 3, 3)
    np.testing.assert_array_equal(tt.closest_point_on_triangles(p, tri),
                                  jt.closest_point_on_triangles(p, tri))
    for rings, segs in ((6, 8), (40, 40)):      # 80 faces, then 3120 > 2048
        f = j_sphere(n_rings=rings, n_segments=segs)
        verts = np.asarray(f.v_template, np.float64) * 1000
        faces = np.asarray(f.faces)
        pts = verts[rng.choice(len(verts), 60)] + rng.randn(60, 3) * 3
        np.testing.assert_array_equal(
            tt.point_to_surface_distance(pts, verts, faces),
            jt.point_to_surface_distance(pts, verts, faces))
        lmk = verts[:7]
        for fc in (faces, None):
            assert tt.now_distance(verts, lmk, pts, lmk + 1.0, fc) == \
                jt.now_distance(verts, lmk, pts, lmk + 1.0, fc)


def test_mask_scan_points_matches_jax():
    rng = np.random.RandomState(1)
    scan = rng.randn(40, 3) * 50
    lmk7 = rng.randn(7, 3) * 10
    cases = [dict(mask=rng.rand(40) > 0.5),
             dict(mask=np.array([3, 1, 7, 7])),
             dict(mask=(rng.rand(40) > 0.5).astype(np.int64)),
             dict(lmk7_mm=lmk7, radius_mm=60.0),
             dict(mask=np.arange(40) < 5, lmk7_mm=lmk7, radius_mm=1e-3),
             dict()]
    for kw in cases:
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            got = tt.mask_scan_points(scan, **kw)
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            want = jt.mask_scan_points(scan, **kw)
        np.testing.assert_array_equal(got, want)
        assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    for kw in (dict(mask=np.zeros(40, bool)), dict(mask=np.ones(39, bool)),
               dict(mask=np.array([0, 40])),
               dict(lmk7_mm=lmk7, radius_mm=1e-6), dict(radius_mm=5.0)):
        with pytest.raises(ValueError) as et:
            tt.mask_scan_points(scan, **kw)
        with pytest.raises(ValueError) as ej:
            jt.mask_scan_points(scan, **kw)
        assert str(et.value) == str(ej.value)


def test_fixture_matches_jax(fixtures):
    """The rendered pictures byte for byte (the renderer's parity makes the
    uint8 arrays equal, PIL the same JPEG); ``scan.npy`` within 1e-3 mm;
    the mask equal but where a point sits within 1e-4 mm of the quantile
    cut."""
    (pt, st), (pj, sj) = fixtures["t"], fixtures["j"]
    jpgs = sorted(p.relative_to(pt) for p in pt.rglob("*.jpg"))
    assert jpgs == sorted(p.relative_to(pj) for p in pj.rglob("*.jpg"))
    assert len(jpgs) == 4
    for rel in jpgs:
        assert filecmp.cmp(pt / rel, pj / rel, shallow=False), rel
    for subject in ("subject000", "subject001"):
        a, b = st / subject, sj / subject
        np.testing.assert_array_equal(np.load(a / "betas.npy"),
                                      np.load(b / "betas.npy"))
        scan_t, scan_j = np.load(a / "scan.npy"), np.load(b / "scan.npy")
        assert scan_t.dtype == scan_j.dtype == np.float32
        np.testing.assert_allclose(scan_t, scan_j, atol=MM_TOL, rtol=0)
        lmk_t, lmk_j = np.load(a / "lmk7.npy"), np.load(b / "lmk7.npy")
        np.testing.assert_allclose(lmk_t, lmk_j, atol=MM_TOL, rtol=0)
        m_t, m_j = np.load(a / "mask.npy"), np.load(b / "mask.npy")
        assert m_t.dtype == m_j.dtype == np.bool_
        d = np.linalg.norm(scan_j - lmk_j.mean(0), axis=-1)
        cut = np.quantile(d, 0.7)
        near = np.abs(d - cut) < 1e-4
        np.testing.assert_array_equal(m_t[~near], m_j[~near])


@pytest.fixture(scope="module")
def runs(mica, fixtures, work):
    """``Tester.run`` of each package on the JAX fixture's pictures with
    the same weights, batches of 3 (a ragged tail)."""
    _, mods, jmods, st = mica
    pictures = fixtures["j"][0]
    t = tt.Tester(mods, tm.make_mica_predict(),
                  cache_path=str(work / "cache_t"))
    j = jt.Tester(jmods, jax.jit(jm.make_mica_predict()),
                  cache_path=str(work / "cache_j"))
    assert t.run(None, pictures, work / "run_t", batch=3) == 4
    assert j.run(st, pictures, work / "run_j", batch=3) == 4
    return work / "run_t", work / "run_j"


def test_tester_run_matches_jax(mica, runs, work):
    """The same tree, the ``.ply`` vertices and ``.npy`` landmarks within
    1e-3 mm, the same faces; the blob caches interchangeable."""
    _, mods, _, _ = mica
    run_t, run_j = runs
    plys = sorted(p.relative_to(run_t) for p in run_t.rglob("*.ply"))
    assert plys == sorted(p.relative_to(run_j) for p in run_j.rglob("*.ply"))
    for rel in plys:
        vt, ft = tt.read_ply(run_t / rel)
        vj, fj = jt.read_ply(run_j / rel)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_allclose(vt, vj, atol=MM_TOL, rtol=0)
        lt = np.load((run_t / rel).with_suffix(".npy"))
        lj = np.load((run_j / rel).with_suffix(".npy"))
        assert lt.dtype == lj.dtype and lt.shape == (7, 3)
        np.testing.assert_allclose(lt, lj, atol=MM_TOL, rtol=0)
    ct = np.load(work / "cache_t.npz")
    cj = np.load(work / "cache_j.npz")
    assert sorted(ct.files) == sorted(cj.files)
    for k in ct.files:
        np.testing.assert_array_equal(ct[k], cj[k])
    # each package reads the other's cache: the port's run on the JAX cache
    # (with no pictures) exports the same tree
    again = tt.Tester(mods, tm.make_mica_predict(),
                      cache_path=str(work / "cache_j"))
    assert again.run(None, work / "absent", work / "run_t2", batch=4) == 4
    assert filecmp.cmp(run_t / plys[0], work / "run_t2" / plys[0],
                       shallow=False)


def test_evaluate_now_identical_reports(fixtures, runs):
    scans = fixtures["j"][1]
    for kw in (dict(), dict(point_to_surface=False),
               dict(face_crop_radius_mm=120.0)):
        got = tt.Tester.evaluate_now(runs[1], scans, **kw)
        want = jt.Tester.evaluate_now(runs[1], scans, **kw)
        assert got == want
        assert got["n"] == 4 and np.isfinite(got["median"])


def test_run_stirling_matches_jax(mica, fixtures, work):
    _, mods, jmods, st = mica
    root = work / "stirling" / "Real_images__Subset_2D_FG2018"
    jpgs = sorted(fixtures["j"][0].rglob("*.jpg"))
    for q, names in (("HQ", ("f1001_01", "f1002_01")),
                     ("LQ", ("m1003_02", "m1004_02"))):
        (root / q).mkdir(parents=True)
        for name, src in zip(names, jpgs[:2] if q == "HQ" else jpgs[2:]):
            (root / q / f"{name}.jpg").write_bytes(src.read_bytes())
    got = tt.Tester(mods, tm.make_mica_predict()).run_stirling(
        None, work / "stirling", work / "st_t", batch=3)
    want = jt.Tester(jmods, jax.jit(jm.make_mica_predict())).run_stirling(
        st, work / "stirling", work / "st_j", batch=3)
    assert got == want == {"HQ": 2, "LQ": 2}
    plys = sorted(p.relative_to(work / "st_t")
                  for p in (work / "st_t").rglob("*.ply"))
    assert len(plys) == 4
    for rel in plys:
        np.testing.assert_allclose(tt.read_ply(work / "st_t" / rel)[0],
                                   jt.read_ply(work / "st_j" / rel)[0],
                                   atol=MM_TOL, rtol=0)


def test_runner_dry_run_and_checkpoint(mica, work):
    """``main([...], device="cpu")``: the dry run (4 images) with the JAX
    report's keys; then ``--pictures``/``--scans`` with ``-ckt`` on a joint
    ``save_state_npz`` file, whose weights the prediction uses."""
    from sr3d_torch.train import checkpoint as tc

    tcfg, mods, _, _ = mica
    _, cfg_path = tiny(get_cfg_defaults(), work)
    out = work / "dry"
    assert tnow.main(["--out", str(out), "--subjects", "2", "--imgs", "2",
                      "-c", str(cfg_path), "--batch", "3"],
                     device="cpu") == 0
    rep = json.loads((out / "now_report.json").read_text())
    ref = jt.Tester.evaluate_now(out, out / "fixture" / "scans")
    assert set(rep) == set(ref)
    assert rep["n"] == 4 and np.isfinite(
        [rep["median"], rep["mean"], rep["std"]]).all()
    assert (out / "now_report.txt").read_text().startswith("NoW evaluation")
    assert (out / "blob_cache.npz").exists()

    ckpt = work / "joint.npz"
    tc.save_train_state(ckpt, mods, tj.init_train_state(mods, tcfg),
                        {"epoch": 1, "global_step": 2})
    out2 = work / "ckpt_run"
    assert tnow.main(["--cpu", "--out", str(out2), "-c", str(cfg_path),
                      "-ckt", str(ckpt),
                      "--pictures", str(out / "fixture" / "pictures"),
                      "--scans", str(out / "fixture" / "scans")]) == 0
    rep2 = json.loads((out2 / "now_report.json").read_text())
    assert rep2["n"] == 4 and rep2["median"] != rep["median"]
    # the same weights through Tester directly give the same report
    t = tt.Tester(mods, tm.make_mica_predict())
    t.run(None, out / "fixture" / "pictures", work / "direct")
    direct = tt.Tester.evaluate_now(work / "direct",
                                    out / "fixture" / "scans")
    assert direct["median"] == pytest.approx(rep2["median"], abs=1e-6)
    assert tnow.main(["--cpu", "--out", str(work / "export_only"),
                      "-c", str(cfg_path), "-ckt", str(ckpt),
                      "--pictures", str(out / "fixture" / "pictures")]) == 0
    assert not (work / "export_only" / "now_report.json").exists()
    assert len(list((work / "export_only").rglob("*.ply"))) == 4
