"""image_restoration_and_enhancement_torch — the PyTorch / CUDA port.

A second package beside the JAX reference (``image_restoration_and_enhancement_tpu``),
written for one NVIDIA H100. It keeps the reference's module layout and names
(``config``, ``ops``, ``models``, ``core``, ``tasks``, ``infer``, ``metrics``,
``data``, ``train``) so each counterpart is easy to find, and it never imports JAX or the
JAX package.

Ported so far: the four tasks of ``RestorationPipeline`` (denoise, super-resolution,
colorize, inpaint) over the SD-1.5 UNet (4- and 9-channel), VAE and CLIP text
encoder, the PLMS/DDIM schedulers, the CFG img2img and inpaint loops, RRDBNet, and
checkpoints in the JAX pipeline layout or diffusers directories, and the
evaluation path (``metrics``, ``ops/image.py``, ``data``, the
``generate_predictions`` and ``evaluate_model`` entry points), and training
(``train``: the fine-tune step and its optax-equivalent optimizer, the
trainer, the VAE pretrain, and the ``train_*`` and ``pretrain_vae`` entry
points). Attention and
GroupNorm(+SiLU) run on hand-written CUDA kernels (``csrc/``, built with nvcc
and bound with ctypes by ``ops/_build.py``); on CPU tensors the same
functions use their plain PyTorch versions.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
