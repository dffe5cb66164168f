"""Training: the fine-tune step, its optimizer, the trainer and the VAE pretrain."""
