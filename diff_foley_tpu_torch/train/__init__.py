"""Training: the first-stage VAE/GAN trainer, its losses and LPIPS/LPAPS."""
