"""UNet, alignment classifier, conditioning encoder and VAE decoder."""
