"""Schedulers, the img2img sampling loop and checkpoint I/O."""
