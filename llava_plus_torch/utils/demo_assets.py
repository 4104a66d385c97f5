"""Deterministic, procedurally drawn demo images.

The reference bundles photographs (its ``images/llava_logo.png``,
``llava_example_cmp.png`` — used by its READMEs and gradio UIs and by the
per-tool ``*_test_message.py`` clients). This repo stays binary-free: the
same flows run from images drawn here at call time, so a fresh checkout
drives the full serve loop (web UI examples, tool-worker smoke clients,
CLI demos) with zero external files and zero network egress.

The port's own copy of ``llava_plus_tpu/utils/demo_assets.py``.
"""

from __future__ import annotations

import base64
import io


def _draw_scene1(Image, ImageDraw):
    """A red ball balanced on a blue box — the 'what is unusual about
    this image?' demo (extreme-ironing stand-in)."""
    im = Image.new("RGB", (336, 336), (236, 240, 246))
    d = ImageDraw.Draw(im)
    d.rectangle([40, 290, 296, 320], fill=(90, 90, 90))          # road
    d.rectangle([120, 180, 216, 290], fill=(60, 90, 200))        # box
    d.ellipse([138, 100, 198, 160], fill=(200, 60, 60))          # ball
    return im


def _draw_scene2(Image, ImageDraw):
    """A lake with a warning sign — the 'what should I be cautious
    about?' demo (waterview stand-in)."""
    im = Image.new("RGB", (336, 336), (205, 228, 245))
    d = ImageDraw.Draw(im)
    d.rectangle([0, 210, 336, 336], fill=(70, 130, 180))          # water
    d.polygon([(60, 120), (110, 200), (10, 200)], fill=(240, 200, 50))
    d.text((48, 150), "!", fill=(0, 0, 0))
    return im


def _draw_logo(Image, ImageDraw):
    """Square logo placeholder (llava_logo.png stand-in)."""
    im = Image.new("RGB", (256, 256), (20, 24, 38))
    d = ImageDraw.Draw(im)
    d.ellipse([48, 48, 208, 208], outline=(240, 160, 60), width=10)
    d.ellipse([96, 96, 160, 160], fill=(240, 160, 60))
    d.text((92, 214), "LLaVA-TPU", fill=(230, 230, 230))
    return im


def _draw_cat(Image, ImageDraw):
    """A cartoon cat on grass — gives the detection/segmentation tool
    smoke clients ('a cat' canned caption) something plausible to box."""
    im = Image.new("RGB", (336, 336), (176, 216, 170))
    d = ImageDraw.Draw(im)
    d.rectangle([0, 250, 336, 336], fill=(110, 170, 100))          # grass
    d.ellipse([110, 150, 230, 260], fill=(120, 120, 130))          # body
    d.ellipse([140, 90, 210, 160], fill=(130, 130, 140))           # head
    d.polygon([(145, 105), (155, 70), (170, 100)], fill=(130, 130, 140))
    d.polygon([(205, 105), (195, 70), (180, 100)], fill=(130, 130, 140))
    d.ellipse([155, 115, 165, 125], fill=(30, 30, 30))             # eyes
    d.ellipse([185, 115, 195, 125], fill=(30, 30, 30))
    d.line([225, 200, 290, 150], fill=(120, 120, 130), width=12)   # tail
    return im


SCENES = {
    "unusual": _draw_scene1,
    "waterview": _draw_scene2,
    "logo": _draw_logo,
    "cat": _draw_cat,
}


def demo_image(name: str = "cat"):
    """Deterministic PIL image by scene name (see ``SCENES``)."""
    from PIL import Image, ImageDraw

    return SCENES[name](Image, ImageDraw)


def demo_image_b64(name: str = "cat", fmt: str = "PNG") -> str:
    buf = io.BytesIO()
    demo_image(name).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def write_demo_images(out_dir: str) -> list:
    """Materialize every scene as a PNG under ``out_dir`` (the offline
    analogue of the reference's checked-in images/ directory)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in SCENES:
        path = os.path.join(out_dir, f"{name}.png")
        demo_image(name).save(path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    import sys

    for p in write_demo_images(sys.argv[1] if len(sys.argv) > 1 else "images"):
        print(p)
