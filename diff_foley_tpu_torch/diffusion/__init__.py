"""Noise schedule, the sampler library, guidance and tiled canvases."""
from .guidance import GuidanceSpec, make_guided_eps_fn
from .samplers import (ddim_decode, ddim_sample, ddim_stochastic_encode,
                       dpm_solver_sample, p_sample_loop, plms_sample,
                       progressive_denoising)
from .schedule import (DiffusionSchedule, extract_into_tensor,
                       make_beta_schedule, make_ddim_sampling_parameters,
                       make_ddim_timesteps, timestep_embedding)
from .tiled import SplitInputParams, tiled_apply

# LatentDiffusion and LDMConfig live in diffusion.latent_diffusion and are
# not re-exported: latent_diffusion imports the models, which import
# diffusion.schedule, and a re-export here would make that cycle depend on
# the import order.
