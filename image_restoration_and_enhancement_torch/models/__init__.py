"""PyTorch models: UNet2DCondition, AutoencoderKL, CLIP text encoder, tokenizer."""
