"""DDPM training and the DDPM and DDIM samplers of the PyTorch port."""

from .schedules import compute_beta_schedule  # noqa: F401
from .ddpm import DDPMTrainer, DDPMSampler  # noqa: F401
from .ddim import DDIMSampler  # noqa: F401
