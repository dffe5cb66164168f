"""Gradio web UI for the restoration pipeline (the port's counterpart of the
repository's ``app.py``).

Image + optional mask upload, four task checkboxes, fine-tuned vs pretrained
mode (re-initializing the pipeline with the "nonexistent" sentinel), a
gallery of original -> per-step -> final results, demo examples from
``data/demo/images`` (``make_demo_data``), served on 0.0.0.0:7860:

    python -m image_restoration_and_enhancement_torch.app [--device cpu]

Serves on the GPU unless ``--device cpu``. Gradio is an optional dependency,
imported only by ``create_interface`` and the command line; without it
``process_image`` still serves programmatically. The gallery holds the
pipeline's uint8 arrays.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

from .device import DeviceLike, resolve_device
from .infer.pipeline import RestorationPipeline

logger = logging.getLogger(__name__)

_pipeline: Optional[RestorationPipeline] = None
_mode = "fine_tuned"

TASK_LABELS = [
    ("Denoise", "denoise"),
    ("Super-resolution x4", "sr_x4"),
    ("Colorize", "colorize"),
    ("Inpaint", "inpaint"),
]


def initialize_pipeline(mode: str = "fine_tuned", device: DeviceLike = None
                        ) -> RestorationPipeline:
    """(Re)create the global pipeline on ``device`` (``cuda`` unless ``"cpu"``);
    "pretrained" uses the "nonexistent" sentinel so no fine-tuned checkpoints
    are loaded. The pipeline is kept while the mode and the device stay."""
    global _pipeline, _mode
    dev = resolve_device(device)
    if _pipeline is not None and mode == _mode and _pipeline.device == dev:
        return _pipeline
    config = None
    if mode == "pretrained":
        config = {name: {"fine_tuned_dir": "nonexistent"} for _, name in TASK_LABELS}
    _pipeline = RestorationPipeline(config=config, device=dev)
    _mode = mode
    return _pipeline


def process_image(image, tasks: List[str], mask=None, mode: str = "fine_tuned",
                  device: DeviceLike = None, **kwargs):
    """Run selected tasks; returns (gallery list of (image, caption), final)."""
    if image is None:
        return [], None
    pipe = initialize_pipeline(mode, device)
    results = pipe.process(image, tasks, mask=mask, **kwargs)
    order = ["original", "denoised", "super_resolved", "colorized", "inpainted", "final"]
    gallery = [(results[k], k) for k in order if k in results]
    return gallery, results["final"]


def create_interface(device: DeviceLike = None):
    import gradio as gr

    with gr.Blocks(title="Image Restoration & Enhancement (H100)") as demo:
        gr.Markdown("# Image Restoration & Enhancement — PyTorch/CUDA")
        with gr.Row():
            with gr.Column():
                image_in = gr.Image(type="pil", label="Input image")
                mask_in = gr.Image(type="pil", label="Inpainting mask (optional)")
                task_boxes = gr.CheckboxGroup(
                    choices=[label for label, _ in TASK_LABELS],
                    value=["Denoise"],
                    label="Tasks (applied in order)",
                )
                mode = gr.Radio(
                    ["fine_tuned", "pretrained"], value="fine_tuned", label="Model mode"
                )
                btn = gr.Button("Restore", variant="primary")
            with gr.Column():
                gallery = gr.Gallery(label="Steps", columns=3)
                final = gr.Image(type="numpy", label="Final")

        label_to_task = dict(TASK_LABELS)

        def _run(image, mask, labels, mode_v):
            tasks = [label_to_task[lbl] for lbl in labels]
            return process_image(image, tasks, mask=mask, mode=mode_v, device=device)

        btn.click(_run, [image_in, mask_in, task_boxes, mode], [gallery, final])

        demo_dir = os.path.join("data", "demo", "images")
        if os.path.isdir(demo_dir):
            examples = [
                [os.path.join(demo_dir, n)] for n in sorted(os.listdir(demo_dir))[:4]
            ]
            gr.Examples(examples=examples, inputs=[image_in])
    return demo


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit(
            "gradio is not installed in this environment. The pipeline is "
            "available programmatically via app.process_image / "
            "image_restoration_and_enhancement_torch.infer.pipeline."
        )
    create_interface(args.device).launch(server_name="0.0.0.0", server_port=7860)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
