"""The port's dataset and RGB codec (``free_hunch_tpu_torch/data``) against
the JAX package's ``free_hunch_tpu/data``: the same items bit for bit, from
a directory and from a zip, at the files' 256 px (the port's own PNG
decoder) and at ``resolution=32`` (PIL's LANCZOS in both), with labels,
``xflip`` and ``max_size``; the same ``shard_indices``; and the same uint8
codes out of ``StandardRGBEncoder``, exact .5 ties included (both round
half to even)."""
import glob
import json
import os
import shutil
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.data import dataset as JD
from free_hunch_tpu.data import encoders as JE
from free_hunch_tpu_torch.data import dataset as TD
from free_hunch_tpu_torch.data import encoders as TE
from free_hunch_tpu_torch.utils.dynamic import construct_class_by_name
from tests._torch_parity import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLED = os.path.join(ROOT, "data", "imagenet", "00000")


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The bundled images as a directory with a dataset.json of labels, and
    the same as a zip."""
    d = tmp_path_factory.mktemp("ds") / "imgs"
    shutil.copytree(BUNDLED, d)
    names = sorted(os.path.basename(p) for p in glob.glob(str(d / "*.png")))
    with open(d / "dataset.json", "w") as f:
        json.dump({"labels": [[n, i % 4] for i, n in enumerate(names)]}, f)
    z = str(d) + ".zip"
    with zipfile.ZipFile(z, "w") as zf:
        for n in names + ["dataset.json"]:
            zf.write(d / n, n)
    return {"dir": str(d), "zip": z}


def _items(ds):
    return [ds[i] for i in range(len(ds))]


CASES = [dict(), dict(resolution=32), dict(use_labels=True), dict(xflip=True),
         dict(max_size=4, random_seed=3), dict(return_idx=True, use_labels=True),
         dict(resolution=32, xflip=True, max_size=3)]


@pytest.mark.parametrize("kind", ["dir", "zip"])
@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(kw) or "plain")
def test_items_equal_jax(sources, kind, kw):
    jd = JD.ImageFolderDataset(sources[kind], **kw)
    td = TD.ImageFolderDataset(sources[kind], **kw)
    assert len(td) == len(jd) and td.name == jd.name
    assert td.image_shape == jd.image_shape and td.label_dim == jd.label_dim
    for a, b in zip(_items(td), _items(jd)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_cache_returns_the_same_items(sources):
    td = TD.ImageFolderDataset(sources["dir"], cache=True)
    first = _items(td)
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(first, _items(td)))


def test_the_jax_class_name_builds_the_port_dataset(sources):
    for name in ("free_hunch_tpu.data.dataset.ImageFolderDataset",
                 "training.dataset.ImageFolderDataset"):
        ds = construct_class_by_name(class_name=name, path=sources["dir"])
        assert isinstance(ds, TD.ImageFolderDataset)
    with pytest.raises(ImportError, match="JAX package"):
        construct_class_by_name(class_name="free_hunch_tpu.eval.Evaluator", opts={})


def test_bad_paths_raise(tmp_path):
    with pytest.raises(IOError):
        TD.ImageFolderDataset(str(tmp_path / "nothing"))
    with pytest.raises(IOError):
        TD.ImageFolderDataset(str(tmp_path))


@pytest.mark.parametrize("n,shards,drop", [(10, 1, False), (10, 3, False), (10, 3, True),
                                           (3, 4, False), (7, 2, True)])
def test_shard_indices_equal_jax(n, shards, drop):
    for s in range(shards):
        assert np.array_equal(TD.shard_indices(n, shards, s, drop),
                              JD.shard_indices(n, shards, s, drop))


def test_rgb_codec_equals_jax():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 3, 16, 16), dtype=np.uint8)
    got = TE.StandardRGBEncoder().encode(torch.as_tensor(u8))
    want = np.asarray(JE.StandardRGBEncoder().encode(jnp.asarray(u8)))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    # floats whose code sits exactly on a .5 tie, around them, and out of range
    codes = np.arange(-3, 259, dtype=np.float64)
    z = np.concatenate([codes / 127.5 - 1, (codes + 0.5) / 127.5 - 1,
                        (codes + 0.4999) / 127.5 - 1, rng.uniform(-1.2, 1.2, 4000)])
    z = z.astype(np.float32)
    ties = np.float32((z + 1.0) * 127.5)
    assert (ties == np.floor(ties) + 0.5).sum() > 100
    got = TE.StandardRGBEncoder().decode(torch.as_tensor(z))
    want = np.asarray(JE.StandardRGBEncoder().decode(jnp.asarray(z)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
