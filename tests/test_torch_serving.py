"""The port's serving slice on the CPU: bucketed ``generate`` against the
JAX package's per-chunk ``_sample_and_decode`` + ``mel_to_wav`` with
shared noise, ``GenerationConfig.return_spec``, the engine's bucket
ladder against JAX's, ``BatchingEngine`` (single, concurrent and oversize
requests, the fan-out against a direct bucketed ``generate`` with the
seed the engine drew, continuation, errors, the warm-up) and
``FoleyServer``'s routes and status codes over HTTP on 127.0.0.1.

The models are test_torch_pipeline.py's tiny pair; the serving
configuration is the JAX serving test's: 2 steps, 2 Griffin-Lim
iterations, no classifier guidance, one sample.
"""
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu import pipeline as jpipe
from diff_foley_tpu.audio.transforms import mel_to_wav as j_mel_to_wav
from diff_foley_tpu.serving import BatchingEngine as JBatchingEngine
from diff_foley_tpu.utils.padding import (
    pad_axis0_to_multiple as j_pad_to_multiple)
from diff_foley_tpu_torch import pipeline as tpipe
from diff_foley_tpu_torch.audio.transforms import wav_to_mel
from diff_foley_tpu_torch.serving import BatchingEngine, FoleyServer, _Request
from diff_foley_tpu_torch.utils.padding import pad_axis0_to_multiple
from test_torch_pipeline import _tiny_pair

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

W = tpipe.WINDOW_SAMPLES
SERVE_KW = dict(steps=2, gl_iters=2, classifier_scale=0.0)


@pytest.fixture(scope="module")
def pair():
    return _tiny_pair()


def _feats(windows: int, seed: int, extra: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (windows * 32 + extra, 512)).astype(np.float32)


def test_pad_axis0_to_multiple_matches_jax():
    x = np.arange(7 * 3).reshape(7, 3)
    for k in (1, 2, 4, 7, 8):
        np.testing.assert_array_equal(pad_axis0_to_multiple(x, k),
                                      j_pad_to_multiple(x, k))


def test_bucketed_generate_matches_jax_per_chunk(pair):
    # 3 windows at bucket 2: two chunks, the last padded with window 2.
    # fp32 end to end; specs in [0, 1]: 1e-4; the waveform after
    # Griffin-Lim: 1e-3 of its peak (test_torch_pipeline's limits)
    pipe_j, pipe_t = pair
    s, bucket = 2, 2
    gen_kw = dict(sample_num=s, **SERVE_KW)
    feats = _feats(3, 60, extra=7)
    fw = j_pad_to_multiple(jpipe.window_features(feats), bucket)
    rng = np.random.default_rng(61)
    x_T = rng.standard_normal((4 * s, 16, 64, 4)).astype(np.float32)
    gen_j = jpipe.GenerationConfig(**gen_kw)
    specs, wavs, phases = [], [], []
    for c in range(2):
        rows = slice(c * bucket * s, (c + 1) * bucket * s)
        k_s, k_g = jax.random.split(jax.random.PRNGKey(70 + c))
        sp = pipe_j._sample_and_decode(
            pipe_j.params, pipe_j.vae_params,
            jnp.asarray(fw[c * bucket:(c + 1) * bucket]), k_s, gen_j,
            x_T=jnp.asarray(x_T[rows]))
        specs.append(sp)
        wavs.append(j_mel_to_wav(sp, k_g, n_iter=gen_j.gl_iters, length=W))
        phases.append(np.array(jax.random.uniform(
            k_g, (bucket * s, 513, 512), dtype=jnp.float32)))
    ref = pipe_j._pack_outputs(jnp.concatenate(specs), jnp.concatenate(wavs),
                               4, 3, gen_j)
    out = pipe_t.generate(feats, gen=tpipe.GenerationConfig(**gen_kw),
                          x_T=torch.from_numpy(x_T),
                          gl_phase=torch.from_numpy(np.concatenate(phases)),
                          bucket_windows=bucket)
    assert out["spec"].shape == ref["spec"].shape == (s, 128, 3 * 512)
    assert out["wav"].shape == ref["wav"].shape == (s, 3 * W)
    assert np.abs(out["spec"] - ref["spec"]).max() <= 1e-4
    peak = np.abs(ref["wav"]).max()
    assert np.abs(out["wav"] - ref["wav"]).max() <= 1e-3 * max(peak, 1e-6)
    with pytest.raises(ValueError, match="8 rows"):
        pipe_t.generate(feats, gen=tpipe.GenerationConfig(**gen_kw),
                        x_T=torch.from_numpy(x_T[:6]), bucket_windows=bucket)


def test_bucketed_chunks_draw_their_own_noise(pair):
    # four equal windows at bucket 2: the two chunks see the same features
    # and must still differ; the same seed gives the same output
    _, pipe = pair
    gen = tpipe.GenerationConfig(sample_num=1, **SERVE_KW)
    feats = np.tile(_feats(1, 62), (4, 1))
    a = pipe.generate(feats, seed=3, gen=gen, bucket_windows=2)
    b = pipe.generate(feats, seed=3, gen=gen, bucket_windows=2)
    np.testing.assert_array_equal(a["wav"], b["wav"])
    np.testing.assert_array_equal(a["spec"], b["spec"])
    sp = a["spec"][0].reshape(128, 4, 512)
    for i in (0, 1):   # window i of chunk 0 against window i of chunk 1
        assert np.abs(sp[:, i] - sp[:, i + 2]).max() > 1e-3
    assert len({tpipe.chunk_seed(3, c) for c in range(64)}
               | {tpipe.chunk_seed(4, c) for c in range(64)}) == 128


def test_return_spec_false_returns_no_spec(pair):
    _, pipe = pair
    gen = tpipe.GenerationConfig(sample_num=1, return_spec=False,
                                 wav_dtype="int16", **SERVE_KW)
    assert tpipe.GenerationConfig().return_spec is True
    feats = _feats(1, 63)
    for kw in ({}, {"bucket_windows": 2}):
        out = pipe.generate(feats, seed=1, gen=gen, **kw)
        assert set(out) == {"wav"}
        assert out["wav"].shape == (1, W) and out["wav"].dtype == np.int16
    known = np.random.default_rng(64).uniform(size=(128, 512)).astype(
        np.float32)
    out = pipe.inpaint(feats, known, tpipe.continuation_mask(512, 128),
                       seed=1, gen=tpipe.GenerationConfig(
                           sampler="ddim", steps=4, sample_num=1, gl_iters=2,
                           classifier_scale=0.0, return_spec=False))
    assert set(out) == {"wav"} and out["wav"].shape == (1, W)


def test_bucket_ladder_matches_jax():
    for cap in range(1, 17):
        for n in range(1, 41):
            assert BatchingEngine._bucket(n, cap) == \
                JBatchingEngine._bucket(n, cap), (n, cap)


# ---- the engine -------------------------------------------------------------

@pytest.fixture(scope="module")
def engine(pair):
    eng = BatchingEngine(pair[1], tpipe.GenerationConfig(
        sample_num=1, return_spec=False, wav_dtype="int16", **SERVE_KW),
        max_batch_windows=4, max_wait_ms=200, seed=5)
    yield eng
    eng.stop()


def test_engine_defaults_are_the_jax_engines():
    class Pipe:   # the engine only calls the pipeline when a request runs
        pass

    eng = BatchingEngine(Pipe())
    try:
        assert (eng.max_windows, eng.max_wait) == (16, 0.03)
        g = eng.gen
        assert (g.sample_num, g.return_spec, g.wav_dtype) == (1, False,
                                                              "int16")
    finally:
        eng.stop()


def _check_fan_out(engine, batch):
    """The batch's results against a direct bucketed generate with the
    seed it drew, sliced per request: bit for bit."""
    seed, bucket = batch[0].seed, batch[0].bucket
    batch = sorted(batch, key=lambda r: r.offset)
    feats = np.concatenate([r.feats for r in batch]).reshape(-1, 512)
    ref = engine.pipe.generate(feats, seed, engine.gen,
                               bucket_windows=bucket)["wav"][0]
    for r in batch:
        w = r.feats.shape[0]
        np.testing.assert_array_equal(
            r.result, ref[r.offset * W:(r.offset + w) * W])


def test_engine_single_and_concurrent_requests(engine):
    wav = engine.submit(_feats(1, 65, extra=5))
    assert wav.shape == (W,) and wav.dtype == np.int16

    reqs = [None] * 5

    def client(i):
        reqs[i] = engine.enqueue(_feats(1 + i % 3, 66 + i))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in reqs:
        assert r.event.wait(300) and r.error is None
        assert r.result.shape == (r.feats.shape[0] * W,)
    batches = {}
    for r in reqs:   # a batch is the requests that share a seed
        batches.setdefault(r.seed, []).append(r)
    for batch in batches.values():
        windows = sum(r.feats.shape[0] for r in batch)
        assert batch[0].bucket == BatchingEngine._bucket(windows, 4)
        _check_fan_out(engine, batch)


def test_engine_fan_out_of_one_batch(engine):
    batch = [_Request(_feats(w, 70 + w).reshape(-1, 32, 512))
             for w in (2, 1)]
    engine._run(batch)
    assert all(r.error is None and r.event.is_set() for r in batch)
    assert [r.offset for r in batch] == [0, 2] and batch[0].bucket == 4
    assert batch[0].seed == batch[1].seed
    _check_fan_out(engine, batch)


def test_engine_oversize_request_runs_fixed_buckets(engine):
    w = 7   # > max_batch_windows 4, and no multiple of it
    r = _Request(_feats(w, 73).reshape(-1, 32, 512))
    engine._run([r])
    assert r.error is None and r.bucket == 4
    assert r.result.shape == (w * W,)
    wav = engine.submit(_feats(w, 73), timeout=300)
    assert wav.shape == (w * W,)


def test_engine_continue_audio(engine):
    spec = np.random.default_rng(74).uniform(size=(128, 128)).astype(
        np.float32)
    wav = engine.continue_audio(_feats(1, 75), spec, known_seconds=2.0)
    assert wav.shape == (W,) and wav.dtype == np.int16
    with pytest.raises(ValueError, match="known_spec"):
        engine.continue_audio(_feats(1, 75), spec[:64], known_seconds=2.0)


def test_engine_reports_a_failure_to_every_request():
    class Failing:
        def generate(self, *a, **k):
            raise RuntimeError("device lost")

    eng = BatchingEngine(Failing(), max_wait_ms=100)
    try:
        batch = [_Request(_feats(1, 76).reshape(-1, 32, 512))
                 for _ in range(2)]
        eng._run(batch)
        assert all(r.event.is_set() and "device lost" in r.error
                   and r.result is None for r in batch)
        with pytest.raises(RuntimeError, match="device lost"):
            eng.submit(_feats(1, 76))
        with pytest.raises(ValueError, match="32 features"):
            eng.submit(_feats(0, 76, extra=31))
    finally:
        eng.stop()


def test_engine_warmup_ladder(engine):
    report = engine.aot_warmup()
    assert list(report) == [1, 2, 4]
    for status, seconds in report.values():
        assert status == "warm" and seconds > 0


# ---- HTTP -------------------------------------------------------------------

def _post(url, body, raw: bool = False):
    data = body if raw else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def server(engine):
    seen = []

    def feature_fn(path):
        seen.append(open(path, "rb").read())
        return _feats(1, 77)

    srv = FoleyServer(engine, port=0, feature_fn=feature_fn)
    srv.start_background()
    yield f"http://127.0.0.1:{srv.port}", seen
    srv.shutdown()


def test_http_healthz_generate_and_video(server, engine):
    base, seen = server
    with urllib.request.urlopen(f"{base}/healthz") as r:
        assert json.loads(r.read()) == {"status": "ok"}
    code, body = _post(f"{base}/generate",
                       {"features": _feats(1, 78).tolist()})
    assert code == 200 and body["sr"] == 16000
    assert body["num_samples"] == W == len(body["wav"])
    assert max(abs(v) for v in body["wav"]) <= 1.0
    code, body = _post(f"{base}/generate_video", b"not really a video",
                       raw=True)
    assert code == 200 and body["num_samples"] == W
    assert seen == [b"not really a video"]


def test_http_continue(server, engine):
    base, _ = server
    feats = _feats(1, 79).tolist()
    spec = np.random.default_rng(80).uniform(size=(128, 96)).tolist()
    code, body = _post(f"{base}/continue", {
        "features": feats, "known_spec": spec, "known_seconds": 1.0})
    assert code == 200 and body["num_samples"] == W
    wav = np.random.default_rng(81).uniform(-0.5, 0.5, 16000).astype(
        np.float32)
    assert wav_to_mel(torch.from_numpy(wav)).shape[0] == 128
    code, body = _post(f"{base}/continue", {
        "features": feats, "known_wav": wav.tolist(), "known_seconds": 1.0})
    assert code == 200 and body["num_samples"] == W
    code, body = _post(f"{base}/continue", {
        "features": feats, "known_wav": wav.tolist(), "sr": 22050,
        "known_seconds": 1.0})
    assert code == 400 and "16000 Hz" in body["error"]


def test_http_errors(server, engine):
    base, _ = server
    assert _post(f"{base}/generate", {"features": [[1.0, 2.0]]})[0] == 400
    assert _post(f"{base}/generate", b"{not json", raw=True)[0] == 400
    assert _post(f"{base}/generate", {"feats": []})[0] == 400
    code, body = _post(f"{base}/continue", {
        "features": _feats(1, 82).tolist(), "known_seconds": 1.0})
    assert code == 400 and "known_spec or known_wav" in body["error"]
    assert _post(f"{base}/nowhere", {})[0] == 404
    try:
        urllib.request.urlopen(f"{base}/nowhere")
        raise AssertionError("GET /nowhere answered")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    bare = FoleyServer(engine, port=0)
    bare.start_background()
    try:
        code, body = _post(f"http://127.0.0.1:{bare.port}/generate_video",
                           b"x", raw=True)
        assert code == 501 and "feature_fn" in body["error"]
    finally:
        bare.shutdown()


def test_http_failed_generation_is_500():
    class Failing:
        def generate(self, *a, **k):
            raise RuntimeError("device lost")

    class Pipe(Failing):
        melspec = tpipe.DEFAULT_MELSPEC

    eng = BatchingEngine(Pipe(), max_wait_ms=10)
    srv = FoleyServer(eng, port=0)
    srv.start_background()
    try:
        code, body = _post(f"http://127.0.0.1:{srv.port}/generate",
                           {"features": _feats(1, 83).tolist()})
        assert code == 500 and "device lost" in body["error"]
    finally:
        srv.shutdown()
        eng.stop()
