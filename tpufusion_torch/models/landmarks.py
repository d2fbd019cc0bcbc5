"""68-point facial landmark providers for FFHQ alignment (port of
``tpufusion/models/landmarks.py``; reference C18).

The reference gets landmarks from a dlib shape predictor
(`utils/alignment.py:9-27`, model path `paths_config.py:30`); dlib is not
shippable here, so this module provides the working detector the alignment
path needs:

- :class:`LandmarkNet` — a small conv regressor (an ``nn.Module``, NHWC in)
  predicting the 68 (x, y) points in normalised [0, 1] image coordinates.
  Weights train with :func:`train_landmark_net` (``torch.optim.Adam``).
- :func:`make_landmark_provider` — adapts a net into the
  ``landmarks_fn(path) -> (68, 2)`` callable that
  ``data.alignment.make_align_preprocess`` consumes, returning pixel
  coordinates of the ORIGINAL image.
- :func:`dlib_landmark_provider` — optional import-guarded dlib adapter.
- :func:`packaged_landmark_provider` — the port's own copy of the trained
  weights (``models/weights/landmark_net.{npz,json}``, byte-identical to the
  JAX package's, in its layout: read through
  ``io.convert.landmark_state_from_jax``).

The net computes in float32 on every device, whatever the pipeline's policy:
it is a 96^2 net whose outputs are scaled to the full image, where bf16's
8-bit mantissa would move a 1024^2 landmark by pixels, at no saving worth
having.

The synthetic faces (``synth_face_batch``) are the JAX package's numpy
``RandomState`` code, copied: the same seed gives the same bits.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import Policy, resolve_device
from tpufusion_torch.core.prng import truncated_normal

N_LANDMARKS = 68

def _flip_permutation() -> np.ndarray:
    """iBUG-68 left-right mirror permutation: ``perm[i]`` is the index whose
    mirrored location point ``i`` lands on.  Derived from (and unit-tested
    against) the synthetic template's geometry, which follows iBUG ordering:
    chin 0-16 reverses, brows 17-26 reverse across the midline, nose bridge
    27-30 is self-mirrored, nostrils 31-35 reverse, eye hexagons swap
    36↔45/37↔44/38↔43/39↔42/40↔47/41↔46, mouth rings mirror in place."""
    perm = np.arange(N_LANDMARKS)
    perm[0:17] = np.arange(16, -1, -1)
    perm[17:27] = np.arange(26, 16, -1)
    perm[31:36] = np.arange(35, 30, -1)
    for a, b in ((36, 45), (37, 44), (38, 43), (39, 42), (40, 47), (41, 46),
                 (48, 54), (49, 53), (50, 52), (55, 59), (56, 58),
                 (60, 64), (61, 63), (65, 67)):
        perm[a], perm[b] = b, a
    return perm


FLIP_PERM = _flip_permutation()


def flip_landmarks(pts: np.ndarray) -> np.ndarray:
    """Landmarks of the horizontally mirrored image, in [0,1] x-coords:
    mirror x and re-index so point i still names the same facial feature."""
    out = np.asarray(pts).copy()
    out[..., 0] = 1.0 - out[..., 0]
    return out[..., FLIP_PERM, :]


# flax's lecun_normal: a normal truncated to +-2 std, its std corrected so
# that the truncated draw has variance 1 / fan_in; biases start at zero
_TRUNC_STD = 0.87962566103423978


def _lecun(shape, fan_in, device, generator):
    return nn.Parameter(truncated_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                                         device=device, generator=generator))


class LandmarkNet(nn.Module):
    """Strided-conv regressor: (N, S, S, 3) in [-1,1] -> (N, 68, 2) in [0,1].

    Four stride-2 3x3 conv stages (padding 1, widths ``width * 2**min(i, 2)``,
    ReLU), a float32 global average pool, ``fc1`` (256, ReLU), ``head``
    (136) and a sigmoid: the JAX package's flax module, with its layer names
    (``conv0`` .. ``conv3``, ``fc1``, ``head``) and torch layouts (OIHW,
    (out, in)). ``policy.compute_dtype`` is the convs' dtype; the pool and
    the two dense layers run in float32, as flax's ``Dense`` promotes them.
    """

    def __init__(self, width: int = 32, *, policy: Optional[Policy] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width = width
        self.policy = policy or Policy()
        cin = 3
        for i in range(4):
            cout = width * 2 ** min(i, 2)
            conv = nn.Conv2d(cin, cout, 3, stride=2, padding=1, device=device)
            conv.weight = _lecun((cout, cin, 3, 3), 9 * cin, device, generator)
            nn.init.zeros_(conv.bias)
            setattr(self, f"conv{i}", conv)
            cin = cout
        self.fc1 = nn.Linear(cin, 256, device=device)
        self.fc1.weight = _lecun((256, cin), cin, device, generator)
        self.head = nn.Linear(256, N_LANDMARKS * 2, device=device)
        self.head.weight = _lecun((N_LANDMARKS * 2, 256), 256, device, generator)
        nn.init.zeros_(self.fc1.bias)
        nn.init.zeros_(self.head.bias)

    def forward(self, x):
        dt = self.policy.compute_dtype
        y = x.to(dt).permute(0, 3, 1, 2)
        for i in range(4):
            conv = getattr(self, f"conv{i}")
            y = F.relu(F.conv2d(y, conv.weight.to(dt), conv.bias.to(dt), stride=2, padding=1))
        y = y.float().mean(dim=(2, 3))
        y = F.relu(self.fc1(y))
        y = self.head(y)
        return torch.sigmoid(y).reshape(y.shape[0], N_LANDMARKS, 2)


def create_landmark_net(*, width: int = 32, policy: Optional[Policy] = None, device=None,
                        seed: int = 0) -> LandmarkNet:
    """A ``LandmarkNet`` with weights drawn from ``seed`` on ``device``
    (``cuda`` unless given), float32 unless ``policy`` says otherwise. The
    JAX package's ``image_size`` argument only shapes flax's init; the net
    takes any input size."""
    device = resolve_device(device)
    return LandmarkNet(width, policy=policy, device=device,
                       generator=torch.Generator(device=device).manual_seed(seed))


# ---------------------------------------------------------------------------
# synthetic face supervision (tests / smoke training)
# ---------------------------------------------------------------------------


def _canonical_template() -> np.ndarray:
    """A rough 68-point face template in [0,1]^2 (iBUG-68 ordering: chin 0-16,
    brows 17-26, nose 27-35, eyes 36-47, mouth 48-67)."""
    t = np.zeros((N_LANDMARKS, 2), np.float32)
    # chin: lower half ellipse
    ang = np.linspace(np.pi, 2 * np.pi, 17)
    t[0:17, 0] = 0.5 + 0.32 * np.cos(ang)
    t[0:17, 1] = 0.55 - 0.38 * np.sin(ang)
    # brows
    t[17:22, 0] = np.linspace(0.28, 0.44, 5)
    t[17:22, 1] = 0.35
    t[22:27, 0] = np.linspace(0.56, 0.72, 5)
    t[22:27, 1] = 0.35
    # nose bridge + nostrils
    t[27:31, 0] = 0.5
    t[27:31, 1] = np.linspace(0.42, 0.58, 4)
    t[31:36, 0] = np.linspace(0.44, 0.56, 5)
    t[31:36, 1] = 0.62
    # eyes (hexagons)
    for base, cx in ((36, 0.36), (42, 0.64)):
        ea = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        t[base:base + 6, 0] = cx + 0.05 * np.cos(ea)
        t[base:base + 6, 1] = 0.44 + 0.03 * np.sin(ea)
    # mouth outer (12) + inner (8)
    ma = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    t[48:60, 0] = 0.5 + 0.10 * np.cos(ma)
    t[48:60, 1] = 0.74 + 0.05 * np.sin(ma)
    mi = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    t[60:68, 0] = 0.5 + 0.05 * np.cos(mi)
    t[60:68, 1] = 0.74 + 0.02 * np.sin(mi)
    return t


def _photometric_augment(img: np.ndarray, rng: np.random.RandomState,
                         yy: np.ndarray, xx: np.ndarray,
                         pts: np.ndarray) -> np.ndarray:
    """Close some of the sketch→photo appearance gap (r4: the real-face
    sanity pass showed the plain sketches do not transfer): random low-freq
    background instead of flat black, a dark hair band above the brows,
    per-channel gain/bias, additive noise, and an occasional box blur."""
    size = img.shape[0]
    # background: smooth random field where the face is dark (img ~ -1);
    # upsample by repeat + crop so any size works (kron needs size % 4 == 0)
    g = rng.uniform(-1.0, 1.0, (4, 4, 3)).astype(np.float32)
    rep = -(-size // 4)  # ceil
    bg = np.repeat(np.repeat(g, rep, axis=0), rep, axis=1)[:size, :size]
    for _ in range(2):  # cheap separable smoothing
        bg = (bg + np.roll(bg, 1, 0) + np.roll(bg, -1, 0)
              + np.roll(bg, 1, 1) + np.roll(bg, -1, 1)) / 5.0
    mask = (img.mean(-1, keepdims=True) + 1.0) * 0.5  # 0 = background
    img = img * mask + bg * (1.0 - mask)
    # hair: dark wide blob above the brow line
    hc = pts[17:27].mean(axis=0) - np.array([0.0, 0.18], np.float32)
    blob = np.exp(-(((xx - hc[0]) / 0.30) ** 2 + ((yy - hc[1]) / 0.16) ** 2))
    hair = rng.uniform(-1.0, -0.2, 3).astype(np.float32)
    img = img * (1 - blob[..., None]) + hair * blob[..., None]
    # photometric jitter + sensor noise
    gain = rng.uniform(0.6, 1.1, 3).astype(np.float32)
    bias = rng.uniform(-0.25, 0.25, 3).astype(np.float32)
    img = img * gain + bias
    img = img + rng.normal(0.0, rng.uniform(0.02, 0.12), img.shape)
    if rng.uniform() < 0.3:
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img.astype(np.float32)


def synth_face_batch(rng: np.random.RandomState, n: int, size: int,
                     augment: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Render n synthetic faces + ground-truth landmarks.

    Faces are blob sketches (skin disc, dark eyes, mouth bar) under a random
    similarity transform; landmarks are the transformed canonical template in
    [0,1] coords.  Enough signal to train/validate the provider end-to-end.
    ``augment=True`` adds photometric/background augmentation for real-photo
    transfer (see :func:`_photometric_augment`).
    """
    tpl = _canonical_template()
    imgs = np.full((n, size, size, 3), -1.0, np.float32)
    lms = np.zeros((n, N_LANDMARKS, 2), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        scale = rng.uniform(0.7, 1.0)
        theta = rng.uniform(-0.25, 0.25)
        shift = rng.uniform(-0.08, 0.08, 2)
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]], np.float32)
        aspect = rng.uniform(0.88, 1.12)
        pts = ((tpl - 0.5) * scale * np.array([aspect, 1.0], np.float32)
               ) @ rot.T + 0.5 + shift
        lms[i] = pts

        def paint(img, ec, col, rx, ry):
            blob = np.exp(-(((xx - ec[0]) / rx) ** 2
                            + ((yy - ec[1]) / ry) ** 2) * 0.5)
            return img * (1 - blob[..., None]) + np.asarray(
                col, np.float32) * blob[..., None]

        # skin: elliptical disc around the face centre, varied tone
        c = pts.mean(axis=0)
        r = np.sqrt(((xx - c[0]) / (0.22 * scale * aspect)) ** 2
                    + ((yy - c[1]) / (0.26 * scale)) ** 2)
        face = np.exp(-0.5 * r ** 2)
        tone = np.array([1.6, 1.2, 0.8], np.float32) * rng.uniform(0.8, 1.1)
        img = face[..., None] * tone - 1.0
        # jaw/face-boundary contour: darken a ring where the disc rolls off
        ring = np.exp(-((r - 1.3) / 0.25) ** 2) * face
        img = img - 0.6 * ring[..., None]
        # brows: elongated dark strokes
        for sl in (slice(17, 22), slice(22, 27)):
            img = paint(img, pts[sl].mean(axis=0), (-0.8, -0.85, -0.9),
                        0.045 * scale, 0.012 * scale)
        # nose: bright ridge along the bridge + dark nostril bar
        bridge = 0.5 * (pts[27] + pts[30])
        img = paint(img, bridge, tone * 1.15 - 1.0,
                    0.018 * scale, 0.06 * scale)
        img = paint(img, pts[31:36].mean(axis=0), (-0.45, -0.5, -0.55),
                    0.032 * scale, 0.012 * scale)
        # eyes: light sclera, dark pupil inside; mouth: red ellipse
        for sl in (slice(36, 42), slice(42, 48)):
            ec = pts[sl].mean(axis=0)
            img = paint(img, ec, (0.9, 0.9, 0.85),
                        0.034 * scale, 0.020 * scale)
            img = paint(img, ec, (-1.0, -1.0, -1.0),
                        0.014 * scale, 0.014 * scale)
        img = paint(img, pts[48:60].mean(axis=0), (0.8, -0.6, -0.6),
                    0.055 * scale, 0.028 * scale)
        # lighting: multiplicative ramp in a random direction
        ld = rng.uniform(0, 2 * np.pi)
        ramp = ((xx - 0.5) * np.cos(ld) + (yy - 0.5) * np.sin(ld))
        img = (img + 1.0) * (1.0 + rng.uniform(0.0, 0.5) * ramp[..., None]) - 1.0
        if augment:
            img = _photometric_augment(img, rng, yy, xx, pts)
        imgs[i] = np.clip(img, -1.0, 1.0)
    return imgs, lms


def quad_point_weights(emphasis: float = 3.0) -> np.ndarray:
    """Per-landmark loss weights emphasising what ``alignment_quad`` reads:
    the two eye rings (36-47) and the mouth corners (48, 54) — the only
    points the FFHQ quad geometry consumes (`utils/alignment.py:34-50`).
    Normalised to mean 1 so the loss scale (and lr) is unchanged."""
    w = np.ones(N_LANDMARKS, np.float32)
    w[36:48] = emphasis
    w[48] = w[54] = emphasis
    return w / w.mean()


def train_landmark_net(net: LandmarkNet, images, landmarks, *, steps: int = 300,
                       lr: float = 2e-3, batch: int = 32, seed: int = 0,
                       point_weights=None):
    """Fit the net in place on (images in [-1,1] NHWC, landmarks in [0,1]):
    ``torch.optim.Adam`` (optax.adam's defaults), each step on a batch of
    indices drawn with replacement from a ``torch.Generator`` seeded with
    ``seed``. Returns ``(net, loss_trace)``, the trace a (steps,) float32
    tensor of the loss before each step.

    ``point_weights``: optional (68,) per-landmark loss weights (see
    :func:`quad_point_weights` for the alignment-targeted preset)."""
    device = next(net.parameters()).device
    images = torch.as_tensor(np.asarray(images), device=device)
    landmarks = torch.as_tensor(np.asarray(landmarks), device=device)
    n = images.shape[0]
    pw = (None if point_weights is None
          else torch.as_tensor(np.asarray(point_weights, np.float32), device=device)[:, None])
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    gen = torch.Generator().manual_seed(seed)
    trace = []
    for _ in range(steps):
        idx = torch.randint(0, n, (batch,), generator=gen).to(device)
        se = (net(images[idx]) - landmarks[idx]) ** 2
        loss = (se if pw is None else se * pw).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        trace.append(loss.detach())
    return net, torch.stack(trace).float().cpu()


# ---------------------------------------------------------------------------
# providers
# ---------------------------------------------------------------------------


def _predict(net: LandmarkNet, x: np.ndarray) -> np.ndarray:
    """(N, S, S, 3) float32 numpy -> (N, 68, 2) float32 numpy, on the net's
    device, without a graph."""
    device = next(net.parameters()).device
    with torch.no_grad():
        return net(torch.as_tensor(np.ascontiguousarray(x), device=device)).float().cpu().numpy()


def make_landmark_provider(net: LandmarkNet, *, net_input_size: int = 128,
                           flip_tta: bool = True) -> Callable:
    """Adapt a LandmarkNet into ``landmarks_fn(path_or_image) -> (68, 2)
    pixel coords`` for ``make_align_preprocess``, on the net's device.

    The image is resized to ``net_input_size`` with PIL's bilinear filter.
    ``flip_tta`` (default on) averages the prediction with the un-mirrored
    prediction on the horizontally flipped image (one batched forward, the
    iBUG-68 mirror permutation). The un-mirror is ``1 - x``, as in the JAX
    package, which carries its ``1 / (2 * S)`` bias: the port keeps it."""
    import PIL.Image

    from tpufusion_torch.core.imaging import from_uint8

    def landmarks_fn(image) -> np.ndarray:
        if isinstance(image, str):
            image = PIL.Image.open(image)
        img = image.convert("RGB")
        w, h = img.size
        small = img.resize((net_input_size, net_input_size), PIL.Image.BILINEAR)
        x = from_uint8(np.asarray(small))[None]
        if flip_tta:
            x = np.concatenate([x, x[:, :, ::-1]], axis=0)
        out = _predict(net, x)
        pts = out[0]
        if flip_tta:
            pts = (pts + flip_landmarks(out[1])) * 0.5
        return pts * np.array([w, h], np.float32)

    return landmarks_fn


def dlib_landmark_provider(predictor_path: str) -> Callable:
    """Exact reference behaviour (`utils/alignment.py:9-27`) when dlib IS
    available; raises ImportError otherwise (import-guarded)."""
    import dlib  # optional dependency; absent in this deployment

    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(predictor_path)

    def landmarks_fn(image) -> np.ndarray:
        # accepts a path or an already-decoded PIL image (the align
        # preprocess hook decodes once and passes the image)
        if isinstance(image, str):
            img = dlib.load_rgb_image(image)
            name = image
        else:
            img = np.asarray(image.convert("RGB"))
            name = "<PIL image>"
        dets = detector(img, 1)
        if not dets:
            raise ValueError(f"no face detected in {name}")
        shape = predictor(img, dets[0])
        return np.array([[p.x, p.y] for p in shape.parts()], np.float32)

    return landmarks_fn


def evaluate_landmark_net(net: LandmarkNet, *, n: int = 64, size: int = 128,
                          seed: int = 12345, augment: bool = False) -> dict:
    """Quantify the provider on HELD-OUT synthetic faces.

    Reports, normalised to the reference's 256^2 alignment frame:
    - ``mean_landmark_err_px_at_256``: mean Euclidean landmark error;
    - ``mean_quad_drift_px_at_256``: mean corner distance between the FFHQ
      alignment quad (``data.alignment.alignment_quad``) computed from the
      predicted vs ground-truth landmarks — the error that actually reaches
      ``align_face`` (`utils/alignment.py:29-115` geometry);
    - ``quad_drift_frac_of_qsize``: that drift relative to the crop size.

    ``augment=True`` evaluates on photometrically-augmented held-out faces.
    """
    from tpufusion_torch.data.alignment import alignment_quad

    rng = np.random.RandomState(seed)
    imgs, gt = synth_face_batch(rng, n, size, augment=augment)
    pred = _predict(net, imgs)
    err = float(np.linalg.norm(pred - gt, axis=-1).mean())  # [0,1] units
    drifts, fracs = [], []
    for i in range(n):
        q_gt, qsize = alignment_quad(gt[i] * size)
        q_pr, _ = alignment_quad(pred[i] * size)
        d = float(np.linalg.norm(q_gt - q_pr, axis=-1).mean())
        drifts.append(d / size)
        fracs.append(d / max(qsize, 1e-6))
    return dict(
        n=n, eval_size=size,
        mean_landmark_err_px_at_256=round(err * 256, 2),
        mean_quad_drift_px_at_256=round(float(np.mean(drifts)) * 256, 2),
        quad_drift_frac_of_qsize=round(float(np.mean(fracs)), 4),
    )


WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")


def load_packaged_landmark_net(*, device=None, policy: Optional[Policy] = None):
    """Load the trained landmark net shipped with the package
    (``models/weights/landmark_net.npz``, the JAX package's trained weights
    in its layout; provenance and measured quality in ``landmark_net.json``)
    on ``device`` (``cuda`` unless given). Returns ``(net, input_size)``:
    pass ``input_size`` as ``make_landmark_provider(...,
    net_input_size=input_size)``."""
    with open(os.path.join(WEIGHTS_DIR, "landmark_net.json")) as f:
        meta = json.load(f)
    net = load_landmark_net(os.path.join(WEIGHTS_DIR, meta["file"]), width=meta["width"],
                            device=device, policy=policy)
    return net, int(meta["input_size"])


def packaged_landmark_provider(*, device=None) -> Callable:
    """``landmarks_fn(path_or_image) -> (68, 2)`` from the packaged net on
    ``device`` (``cuda`` unless given)."""
    net, size = load_packaged_landmark_net(device=device)
    return make_landmark_provider(net, net_input_size=size)


def save_landmark_net(net: LandmarkNet, path: str, *, input_size: Optional[int] = None) -> str:
    """Save the weights in the JAX package's layout (``io.params_io``), so
    either package loads them; when ``input_size`` is given, also write a
    ``<path>.json`` sidecar recording it (the npz itself carries no size —
    the net's global average pool accepts ANY input size without error, so
    evaluating at the wrong one silently degrades instead of failing).
    Returns the path written."""
    from tpufusion_torch.io.convert import landmark_state_to_jax
    from tpufusion_torch.io.params_io import save_pytree

    out = save_pytree(landmark_state_to_jax(net.state_dict()), path)
    if input_size is not None:
        with open(out + ".json", "w") as f:
            json.dump({"input_size": int(input_size), "width": int(net.width)}, f)
    return out


def landmark_net_input_size(path: str) -> Optional[int]:
    """Training input size recorded in the sidecar next to ``path``, or
    ``None`` for sidecar-less files.  Probes ``<path>.json`` (written by
    :func:`save_landmark_net`) and then ``<stem>.json`` (the packaged
    ``landmark_net.json`` schema) — both carry ``input_size``, so passing
    ``--landmark_net .../weights/landmark_net.npz`` resolves the trained
    size instead of silently driving a 96-trained net at the default 128."""
    import json
    import os

    for candidate in (path + ".json", os.path.splitext(path)[0] + ".json"):
        if os.path.exists(candidate):
            try:
                with open(candidate) as f:
                    size = json.load(f).get("input_size")
            except (ValueError, OSError):
                continue  # foreign/unreadable same-stem JSON — keep probing
            if size is not None:
                return int(size)
    return None




def load_landmark_net(path: str, *, width: Optional[int] = None, device=None,
                      policy: Optional[Policy] = None) -> LandmarkNet:
    """A ``LandmarkNet`` on ``device`` (``cuda`` unless given) with the
    weights of a JAX-layout ``.npz`` (written by either package's
    ``save_landmark_net``); ``width`` is read from ``conv0`` when not
    given. Every weight is frozen."""
    from tpufusion_torch.io.convert import landmark_state_from_jax, state_dict_to_torch
    from tpufusion_torch.io.params_io import load_pytree

    device = resolve_device(device)
    variables = load_pytree(path)
    if width is None:  # infer from conv0's out-channels
        width = int(variables["params"]["conv0"]["kernel"].shape[-1])
    net = LandmarkNet(width, policy=policy, device=device)
    net.load_state_dict(state_dict_to_torch(landmark_state_from_jax(variables), device))
    return net.requires_grad_(False)
