"""Host utilities of the port: film output, checkpoints, SSIM."""
