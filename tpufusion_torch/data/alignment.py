"""FFHQ face alignment (copy of ``tpufusion/data/alignment.py``, apart from
the landmark net's device in ``resolve_align_preprocess``) — reference C18
(`utils/alignment.py:9-115`).

The reference detects 68 dlib landmarks and applies the FFHQ-standard
oriented-quad crop (shrink, border crop, reflect-pad with blurred edges, quad
transform to 256^2).  dlib is not available here, so the landmark source is a
pluggable callable ``landmarks_fn(path) -> (68, 2) array``; the geometry is
re-implemented below and is what actually matters for parity.

Alignment only runs when the CLI passes ``--align``
(`attack_main2.py:103-104`), so pipelines work fully without a detector.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import PIL.Image
from scipy import ndimage

# index ranges of the 68-point annotation the geometry consumes
FFHQ_LANDMARK_SLICES = {
    "chin": slice(0, 17),
    "eyebrow_left": slice(17, 22),
    "eyebrow_right": slice(22, 27),
    "nose": slice(27, 31),
    "nostrils": slice(31, 36),
    "eye_left": slice(36, 42),
    "eye_right": slice(42, 48),
    "mouth_outer": slice(48, 60),
    "mouth_inner": slice(60, 68),
}


def alignment_quad(landmarks: np.ndarray):
    """FFHQ oriented crop rectangle from 68 landmarks -> (quad (4,2), qsize)."""
    lm = np.asarray(landmarks, dtype=np.float64)
    eye_l = lm[FFHQ_LANDMARK_SLICES["eye_left"]].mean(axis=0)
    eye_r = lm[FFHQ_LANDMARK_SLICES["eye_right"]].mean(axis=0)
    eye_avg = (eye_l + eye_r) / 2.0
    eye_to_eye = eye_r - eye_l
    mouth = lm[FFHQ_LANDMARK_SLICES["mouth_outer"]]
    mouth_avg = (mouth[0] + mouth[6]) / 2.0
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    return quad, np.hypot(*x) * 2.0


def align_face(
    image: "PIL.Image.Image | str",
    landmarks: np.ndarray,
    *,
    output_size: int = 256,
    transform_size: int = 256,
    enable_padding: bool = True,
) -> PIL.Image.Image:
    """Apply the FFHQ alignment given precomputed landmarks."""
    if isinstance(image, str):
        image = PIL.Image.open(image)
    img = image.convert("RGB")
    quad, qsize = alignment_quad(landmarks)

    # Shrink for speed when the source is much larger than the crop.
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (
            int(np.rint(img.size[0] / shrink)),
            int(np.rint(img.size[1] / shrink)),
        )
        img = img.resize(rsize, PIL.Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    # Crop to the quad bounding box plus a safety border.
    border = max(int(np.rint(qsize * 0.1)), 3)
    bbox = (
        int(np.floor(quad[:, 0].min())) - border,
        int(np.floor(quad[:, 1].min())) - border,
        int(np.ceil(quad[:, 0].max())) + border,
        int(np.ceil(quad[:, 1].max())) + border,
    )
    bbox = (
        max(bbox[0], 0), max(bbox[1], 0),
        min(bbox[2], img.size[0]), min(bbox[3], img.size[1]),
    )
    if bbox[2] - bbox[0] < img.size[0] or bbox[3] - bbox[1] < img.size[1]:
        img = img.crop(bbox)
        quad -= bbox[0:2]

    # Reflect-pad when the quad pokes outside, with blurred feathering.
    pad = (
        int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
        int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())),
    )
    pad = (
        max(-pad[0] + border, 0), max(-pad[1] + border, 0),
        max(pad[2] - img.size[0] + border, 0), max(pad[3] - img.size[1] + border, 0),
    )
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(
            np.float32(img), ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect"
        )
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / pad[0], np.float32(w - 1 - xx) / pad[2]),
            1.0 - np.minimum(np.float32(yy) / pad[1], np.float32(h - 1 - yy) / pad[3]),
        )
        blur = qsize * 0.02
        arr += (ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) * np.clip(
            mask * 3.0 + 1.0, 0.0, 1.0
        )
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = PIL.Image.fromarray(np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB")
        quad += pad[:2]

    img = img.transform(
        (transform_size, transform_size), PIL.Image.QUAD,
        (quad + 0.5).flatten(), PIL.Image.BILINEAR,
    )
    if output_size < transform_size:
        img = img.resize((output_size, output_size), PIL.Image.LANCZOS)
    return img


def make_align_preprocess(landmarks_fn: Callable[[str], np.ndarray],
                          output_size: int = 256):
    """Dataset ``preprocess`` hook: path -> aligned PIL image
    (the reference's ``run_alignment``, `attack_main2.py:185-189`)."""

    def preprocess(path: str) -> PIL.Image.Image:
        # decode ONCE and hand the PIL image to both the landmark provider
        # and the aligner (each accepts a path too, but opening twice would
        # double the host JPEG/PNG decode work per item on the 1-core host)
        img = PIL.Image.open(path)
        return align_face(img, landmarks_fn(img), output_size=output_size)

    return preprocess


def resolve_align_preprocess(landmark_net: str | None,
                             dlib_predictor: str | None,
                             output_size: int = 256, *, device=None):
    """CLI-level helper: build the align ``preprocess`` hook from a trained
    LandmarkNet weights file or a dlib predictor path (shared by
    ``attack_run --align`` and ``invert --align``).  With neither given,
    falls back to the packaged trained net
    (``models/weights/landmark_net.npz``) — the analogue of the reference's
    downloaded dlib model (`paths_config.py:30`). The net runs on ``device``
    (``cuda`` unless given)."""
    if landmark_net:
        from tpufusion_torch.models.landmarks import (
            landmark_net_input_size,
            load_landmark_net,
            make_landmark_provider,
        )

        lnet = load_landmark_net(landmark_net, device=device)
        # drive the net at its TRAINING input size when the save recorded
        # one (the sidecar of save_landmark_net); the global-average-pool
        # head accepts any size, so a mismatch degrades silently
        size = landmark_net_input_size(landmark_net)
        landmarks_fn = make_landmark_provider(
            lnet, **({"net_input_size": size} if size else {}))
    elif dlib_predictor:
        from tpufusion_torch.models.landmarks import dlib_landmark_provider

        landmarks_fn = dlib_landmark_provider(dlib_predictor)
    else:
        from tpufusion_torch.models.landmarks import packaged_landmark_provider

        landmarks_fn = packaged_landmark_provider(device=device)
    return make_align_preprocess(landmarks_fn, output_size=output_size)
