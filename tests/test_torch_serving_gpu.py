"""The port's ``BatchingEngine`` on the card at a tiny config (``gpu``
marker): every request of a batch gets one int16 waveform of its length.
No JAX import, so the file runs where only the port is installed."""
import numpy as np
import pytest
import torch

from diff_foley_tpu_torch import pipeline as tpipe
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.serving import BatchingEngine
from diff_foley_tpu_torch.utils.init import randomize_


@pytest.mark.gpu
def test_engine_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    # head dims the packed kernels take: 80 in the UNet, 32 in the
    # classifier and the VAE's mid attention
    ldm = randomize_(tld.LatentDiffusion(tld.LDMConfig(
        unet=tu.UNetConfig(model_channels=160, num_res_blocks=1,
                           channel_mult=(1, 2), attention_resolutions=(2,),
                           num_heads=4, context_dim=24),
        vae=tv.VAEConfig(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1),
        cond_embed_dim=24)), 84)
    clf = randomize_(tu.ClassifierBackbone(tu.UNetConfig(
        out_channels=1, model_channels=32, num_res_blocks=1,
        channel_mult=(1, 2), attention_resolutions=(2,), num_heads=2,
        context_dim=512)), 85)
    pipe = tpipe.DiffFoleyPipeline(ldm, clf, device="cuda")
    eng = BatchingEngine(pipe, tpipe.GenerationConfig(
        steps=2, gl_iters=2, sample_num=1, return_spec=False,
        wav_dtype="int16"), max_batch_windows=4, max_wait_ms=200)
    try:
        rng = np.random.default_rng(86)
        reqs = [eng.enqueue(rng.standard_normal((w * 32, 512)).astype(
            np.float32)) for w in (1, 2, 3)]
        for r in reqs:
            assert r.event.wait(300) and r.error is None, r.error
            assert r.result.dtype == np.int16
            assert r.result.shape == (r.feats.shape[0]
                                      * tpipe.WINDOW_SAMPLES,)
            assert np.abs(r.result.astype(np.int32)).max() > 0
    finally:
        eng.stop()
