"""The port's ``data/synthetic.py`` against the JAX package's, on the CPU:
every generator gives the same arrays (bit for bit), the two writers write
byte-identical files for the same arguments (tar shards with their JPEG
strips, ``.npy`` specs, ``.npz`` features, the split files), and the
port's own loaders read what they write: ``data/cavp_shards.py::
iter_shards`` the shards, ``SpecFeatDataset.from_split_file`` the data
directory.
"""
import os

import numpy as np
import pytest
import torch

from diff_foley_tpu.data import synthetic as jsyn
from diff_foley_tpu_torch.data import synthetic as tsyn
from diff_foley_tpu_torch.data.cavp_shards import CAVPShardConfig, iter_shards
from diff_foley_tpu_torch.data.ldm_dataset import (LDMDataConfig,
                                                   SpecFeatDataset)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")


def _files(root: str) -> dict:
    """{path under root: bytes} of every file."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_generators_equal_jax():
    tau = np.linspace(0.0, 1.0, 17, dtype=np.float32)
    np.testing.assert_array_equal(tsyn.modulation(tau, 0.3),
                                  jsyn.modulation(tau, 0.3))
    for kw in ({}, {"spread": False}, {"n_classes": 4}):
        assert tsyn.item_params(9, 3, **kw) == jsyn.item_params(9, 3, **kw)
    for name, kw in (("synthetic_spec", dict(frames=64)),
                     ("synthetic_frames", dict(t=8, size=16)),
                     ("synthetic_feat", dict(t=8, dim=64))):
        a = getattr(tsyn, name)(0.4, 0.7, np.random.default_rng(1), **kw)
        b = getattr(jsyn, name)(0.4, 0.7, np.random.default_rng(1), **kw)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    a = tsyn.holdout_pairs(3, video_len=8, spec_frames=64, seed=5)
    b = jsyn.holdout_pairs(3, video_len=8, spec_frames=64, seed=5)
    assert set(a) == set(b) == {"video", "spec", "c"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_cavp_shards_byte_identical_and_read_by_the_port(tmp_path):
    kw = dict(n_shards=2, items_per_shard=3, frame_size=16, video_len=40,
              spec_frames=640, seed=4)
    params = tsyn.write_cavp_shards(str(tmp_path / "port"), **kw)
    assert params == jsyn.write_cavp_shards(str(tmp_path / "jax"), **kw)
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == ["shard-000000.tar", "shard-000001.tar"]
    assert port == ref
    shards = sorted(str(tmp_path / "port" / n) for n in port)
    cfg = CAVPShardConfig(clip_num=2, frame_size=16)
    samples = list(iter_shards(shards, cfg=cfg, shuffle_buffer=4))
    assert len(samples) == 6
    for s in samples:
        # clip_num windows of 4 s: 16 frames at 4 FPS, 256 spec frames
        assert s["video"].shape == (2, 16, 16, 16, 3)
        assert s["spec"].shape == (2, 128, 256)
        assert np.isfinite(s["spec"]).all()
        assert 0.0 <= s["video"].min() and s["video"].max() <= 1.0


@pytest.mark.parametrize("variant", ["fourier", "classes", "encoder"])
def test_ldm_data_dir_byte_identical_and_read_by_the_port(tmp_path, variant):
    kw = dict(n_train=4, n_test=2, spec_frames=512, feat_len=32,
              feat_dim=512, seed=2)
    if variant == "classes":
        kw["n_classes"] = 2
    if variant == "encoder":
        # frames (32, 16, 16, 3) → (32, 512): a fixed projection
        proj = np.random.default_rng(9).standard_normal((768, 512)).astype(
            np.float32)
        kw["encode_fn"] = lambda f: f.reshape(32, -1) @ proj
    out = tsyn.write_ldm_data_dir(str(tmp_path / "port"), **kw)
    assert out == jsyn.write_ldm_data_dir(str(tmp_path / "jax"), **kw)
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(port) == 2 + 2 * 6 and port == ref
    ds = SpecFeatDataset.from_split_file(
        str(tmp_path / "port"), "train",
        LDMDataConfig(duration=2.0, truncate=16384), seed=0)
    assert len(ds.spec_paths) == 4
    item = ds[0]
    # 16384 samples at hop 256: 64 spec frames, ×3 channels; 4 features
    assert item["spec"].shape == (128, 64, 3)
    assert item["video_feat"].shape == (4, 512)
    assert np.isfinite(item["spec"]).all()
    assert np.isfinite(item["video_feat"]).all()
    feat = np.load(tmp_path / "port" / "CAVP_feat" / "Train" / "train0.npz")
    assert feat["feat"].shape == (32, 512)
