"""The port's data layer against the JAX package's, on the CPU: the
synthetic generators write the same files (the arrays of an ``.npz``,
whose zip stamps the time of writing), the rendered ones too; the datasets
(img, lmdb, srpk; joint, train and eval, flips included), the loaders
(``num_workers`` 0 and 2, over epochs) and the splits give equal items,
batches and indices; a resumed loader continues an unbroken pass; the
metrics equal the JAX host versions exactly and its device versions
within 1e-5.  Host numpy, so seconds."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from sr3d_torch import data as tdata
from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.config import update_cfg as t_update
from sr3d_torch.data import joint as tjoint
from sr3d_torch.data import lmdb_reader as tlmdb
from sr3d_torch.data import srpk as tsrpk
from sr3d_torch.data import synthetic as tsyn
from sr3d_torch.eval import metrics as tmet
from sr3d_tpu import data as jdata
from sr3d_tpu.config.defaults import get_cfg_defaults, update_cfg
from sr3d_tpu.data import joint as jjoint
from sr3d_tpu.data import lmdb_reader as jlmdb
from sr3d_tpu.data import srpk as jsrpk
from sr3d_tpu.data import synthetic as jsyn
from sr3d_tpu.eval import metrics as jmet

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _files(root: Path) -> dict[str, bytes]:
    """Every file under ``root``, its bytes; an ``.npz`` (a zip, which
    stamps each member with the time it was written) as the bytes of its
    arrays."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.suffix == ".npz":
            with np.load(p) as z:
                out[str(p.relative_to(root))] = b"".join(
                    k.encode() + z[k].tobytes() for k in sorted(z.files))
        elif p.is_file():
            out[str(p.relative_to(root))] = p.read_bytes()
    return out


def _equal_items(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Each package's generators into their own directories: an SR root
    and a joint root (5 actors of 3 images, one of 2)."""
    out = {}
    for name, syn in (("torch", tsyn), ("jax", jsyn)):
        base = tmp_path_factory.mktemp(f"data_{name}")
        syn.generate_synthetic_faces(base / "sr", n=5, l_res=8, r_res=16,
                                     seed=2)
        syn.generate_synthetic_joint_root(
            base / "joint", name="SYNTH", n_actors=5, imgs_per_actor=3,
            img_res=32, lr_res=8, hr_res=16, n_shape=16, n_exp=8, seed=1)
        out[name] = base
    return out


@pytest.mark.parametrize("kind", ["sr", "joint"])
def test_generators_write_the_same_files(roots, kind):
    a, b = _files(roots["torch"] / kind), _files(roots["jax"] / kind)
    assert list(a) == list(b) and len(a) > 10
    for k in a:
        assert a[k] == b[k], k


def test_rendered_generators_match_jax(tmp_path):
    """The identity-correlated root renders each actor's FLAME shape: with
    the port's renderer and FLAME the same files as the JAX package's."""
    from sr3d_torch.models.flame import sphere_flame as t_sphere
    from sr3d_tpu.models.flame import sphere_flame as j_sphere

    for name, syn, fl in (("torch", tsyn, t_sphere(n_shape=8, n_exp=4)),
                          ("jax", jsyn, j_sphere(n_shape=8, n_exp=4))):
        syn.generate_correlated_joint_root(
            tmp_path / name, fl, n_actors=2, imgs_per_actor=2, img_res=48,
            lr_res=8, hr_res=16, seed=3, texture_identity=0.3)
    a, b = _files(tmp_path / "torch"), _files(tmp_path / "jax")
    assert list(a) == list(b) and len(a) > 10
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("split,need_lr", [("train", True), ("val", False)])
def test_lrhr_items_match_jax(roots, split, need_lr):
    """Items equal, flips included, over three accesses of each index."""
    kw = dict(l_resolution=8, r_resolution=16, split=split, need_LR=need_lr,
              seed=4)
    t = tdata.LRHRDataset(roots["torch"] / "sr", **kw)
    j = jdata.LRHRDataset(roots["jax"] / "sr", **kw)
    plain = jdata.LRHRDataset(roots["jax"] / "sr", **dict(kw, split="val"))
    assert len(t) == len(j) == 5
    flips = 0
    for _ in range(3):
        for i in range(5):
            a, b = t[i], j[i]
            assert Path(a.pop("path_sr")).name == Path(b.pop("path_sr")).name
            _equal_items(a, b)
            flips += int(not np.array_equal(a["HR"], plain[i]["HR"]))
    assert (flips > 0) == (split == "train")


def test_lrhr_rejects_unknown_datatype(roots):
    for pkg in (tdata, jdata):
        with pytest.raises(NotImplementedError, match="not recognized"):
            pkg.LRHRDataset(roots["torch"] / "sr", 8, 16, datatype="tar")


def _lmdb_store(l: int, r: int, n: int) -> dict[bytes, bytes]:
    from PIL import Image

    rng = np.random.RandomState(0)
    store = {b"length": str(n).encode()}
    for i in range(n):
        for name, size in ((f"hr_{r}", r), (f"sr_{l}_{r}", r),
                           (f"lr_{l}", l)):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (size, size, 3),
                                        np.uint8)).save(buf, format="PNG")
            store[f"{name}_{i:05d}".encode()] = buf.getvalue()
    del store[b"hr_16_00002"]      # an index the dataset resamples
    return store


def test_lmdb_items_match_jax(tmp_path):
    """The port's writer and reader make and read the JAX package's files;
    ``datatype: lmdb`` items equal, the resampled index included."""
    store = _lmdb_store(8, 16, 4)
    tlmdb.write_lmdb(tmp_path / "t", store)
    jlmdb.write_lmdb(tmp_path / "j", store)
    assert (tmp_path / "t" / "data.mdb").read_bytes() == \
        (tmp_path / "j" / "data.mdb").read_bytes()
    with tlmdb.LmdbReader(tmp_path / "j") as rd:
        assert dict(rd.items()) == store
    kw = dict(l_resolution=8, r_resolution=16, split="train", need_LR=True,
              datatype="lmdb", seed=1)
    t = tdata.LRHRDataset(tmp_path / "t", **kw)
    j = jdata.LRHRDataset(tmp_path / "j", **kw)
    for i in (0, 2, 3, 2):
        _equal_items(t[i], j[i])


@pytest.mark.parametrize("native", [True, False])
def test_srpk_items_match_jax(roots, tmp_path, native):
    """The packed stores of the port and the JAX package are the same
    bytes; the port's reader (``native/srpk.cc`` built with g++, and the
    memmap plain version) gives the JAX items."""
    tsrpk.pack_lrhr_root(roots["torch"] / "sr", 8, 16, tmp_path / "t")
    jsrpk.pack_lrhr_root(roots["jax"] / "sr", 8, 16, tmp_path / "j")
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    t = tsrpk.SrpkImageDataset(tmp_path / "t", 8, 16, need_LR=True,
                               split="train", seed=2, native=native)
    j = jsrpk.SrpkImageDataset(tmp_path / "j", 8, 16, need_LR=True,
                               split="train", seed=2)
    for i in (0, 3, 0, 4):
        a, b = t[i], j[i]
        a.pop("path_sr"), b.pop("path_sr")
        _equal_items(a, b)
    _equal_items(t.read_batch([4, 1, 1]), j.read_batch([4, 1, 1]))
    if native:
        assert t.hr._handle is not None


@pytest.mark.parametrize("is_train,pairs", [(True, False), (False, False),
                                            (True, True)])
def test_joint_items_match_jax(roots, is_train, pairs):
    """Train (K draws with replacement, flips) and eval (the dataset-wide
    K) items equal over repeated accesses."""
    kw = dict(name="SYNTH", K=4, lr_res=8, hr_res=16, n_shape=16, n_exp=8,
              is_train=is_train, use_pairs=pairs, seed=5)
    t = tjoint.JointFaceDataset(roots["torch"] / "joint", **kw)
    j = jjoint.JointFaceDataset(roots["jax"] / "joint", **kw)
    assert t.actors == j.actors and t._eval_k == j._eval_k
    if pairs:     # the synthetic names have no _1C/_2C views
        assert len(t) == len(j) == 0
        return
    for i in (0, 1, 0, 4, 1):
        _equal_items(t[i], j[i])


def test_filter_pairs_matches_jax():
    names = ["a/001_faceA_1C.png", "a/002_faceA_2C.png",
             "a/003_faceA_1C.png", "a/004_faceA_2C.png",
             "a/010_faceB_1C.png", "a/012_faceB_2C.png",
             "a/noidx_faceD_1C.png", "a/noidx_faceD_2C.png",
             "a/x_faceE_2C.png"]
    assert tjoint._filter_pairs(names) == jjoint._filter_pairs(names)


def _joint_ds(pkg, root):
    return pkg.ConcatDataset([pkg.JointFaceDataset(
        root, name="SYNTH", K=2, lr_res=8, hr_res=16, n_shape=16, n_exp=8,
        seed=s) for s in (0, 1)])


@pytest.mark.parametrize("workers", [0, 2])
def test_batch_loader_matches_jax(roots, workers):
    """Shuffled, threaded: the same batches in the same order over three
    epochs (``epoch()`` twice, then the endless iterator)."""
    t = tdata.BatchLoader(_joint_ds(tdata, roots["torch"] / "joint"), 3,
                          shuffle=True, seed=7, num_workers=workers)
    j = jdata.BatchLoader(_joint_ds(jdata, roots["jax"] / "joint"), 3,
                          shuffle=True, seed=7, num_workers=workers)
    assert len(t) == len(j) == 3
    got = [*t.epoch(), *t.epoch()]
    ref = [*j.epoch(), *j.epoch()]
    it_t, it_j = iter(t), iter(j)
    got += [next(it_t) for _ in range(3)]
    ref += [next(it_j) for _ in range(3)]
    for a, b in zip(got, ref, strict=True):
        _equal_items(a, b)


def test_resumed_loader_continues_the_pass(roots):
    """``skip(n)`` starts the endless pass n batches in, with the shuffles
    and the per-item draws an unbroken pass would have used."""
    def loader():
        base = _joint_ds(tdata, roots["torch"] / "joint")
        ds = tdata.random_split(base, 0.8, seed=0)[0]
        return tdata.BatchLoader(ds, 2, shuffle=True, seed=3, num_workers=0)

    whole = loader()
    it = iter(whole)
    ref = [next(it) for _ in range(11)]
    resumed = loader()
    resumed.skip(7)
    it = iter(resumed)
    for b in ref[7:]:
        _equal_items(next(it), b)


def test_splits_and_builders_match_jax(roots, tmp_path):
    cfg_path = str(REPO / "configs" / "tiny_8_16_model2.yml")
    for n, frac, seed in ((5, 0.8, 0), (17, 0.8, 3), (1, 0.8, 0),
                          (10, 0.5, 9)):
        base = list(range(n))
        t_tr, t_va = tdata.random_split(base, frac, seed=seed)
        j_tr, j_va = jdata.random_split(base, frac, seed=seed)
        assert t_tr.indices == j_tr.indices
        assert t_va.indices == j_va.indices
    cfgs = []
    for defaults, update in ((t_defaults, t_update),
                             (get_cfg_defaults, update_cfg)):
        c = update(defaults(), cfg_path)
        c.mica.datasets.root = str(roots["torch"] / "joint")
        c.mica.datasets.training_data = ["SYNTH", "SYNTH"]
        c.mica.datasets.K = 2
        cfgs.append(c)
    for t_build, j_build in ((tdata.build_train, jdata.build_train),
                             (tdata.build_val, jdata.build_val)):
        t, j = t_build(cfgs[0]), j_build(cfgs[1])
        assert len(t) == len(j) > 0
        for i in (0, len(t) - 1, -1):
            _equal_items(t[i], j[i])


def test_host_metrics_equal_jax():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (24, 20, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-20, 20, a.shape), 0, 255) \
        .astype(np.uint8)
    assert tmet.calculate_psnr(a, b) == jmet.calculate_psnr(a, b)
    assert tmet.calculate_psnr(a, a) == jmet.calculate_psnr(a, a)
    for x, y in ((a, b), (a[..., 0], b[..., 0]), (a[..., :1], b[..., :1])):
        assert tmet.calculate_ssim(x, y) == jmet.calculate_ssim(x, y)
    np.testing.assert_array_equal(tmet.gaussian_kernel_1d(),
                                  jmet.gaussian_kernel_1d())


def test_device_metrics_match_jax():
    import jax

    rng = np.random.RandomState(1)
    a = rng.uniform(0, 255, (20, 22, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 9, a.shape), 0, 255).astype(np.float32)
    for x, y in ((a, b), (a[..., 0], b[..., 0])):
        ref = jax.jit(jmet.ssim_device)(x, y)
        got = tmet.ssim_device(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(got) - float(ref)) < 1e-5
        # and the host formula, in float32
        assert abs(float(got) - tmet.ssim(x, y)) < 1e-4
    ref = jax.jit(jmet.psnr_device)(a, b)
    got = tmet.psnr_device(torch.from_numpy(a), torch.from_numpy(b))
    assert abs(float(got) - float(ref)) < 1e-5
