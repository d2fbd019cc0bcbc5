"""Native ViT image classifier, the cars ("stanford-car-vit-patch16") model
the reference attacks with PGD and CW (port of ``tpufusion/models/vit.py``).

The ViT-B/16 encoder the HF checkpoint carries: patch-conv embedding, cls
token + learned position embeddings, pre-LN transformer blocks with
exact-GELU MLPs, a final LayerNorm, a linear head on the cls token.
LayerNorms (eps 1e-12), the attention logits and their softmax run in
float32; the projections in the compute dtype; the head in float32.
Attention is a plain ``matmul`` + ``softmax``, as the JAX package computes
it with ``einsum`` and no Pallas kernel.

Parameters carry HF ``ViTForImageClassification`` names
(``vit.embeddings.{cls_token, position_embeddings,
patch_embeddings.projection}``, ``vit.encoder.layer.{i}.*``,
``vit.layernorm``, ``classifier``), so a ``pytorch_model.bin`` loads with
``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpufusion_torch.core.dtypes import Policy, default_policy, resolve_device
from tpufusion_torch.core.prng import truncated_normal
from tpufusion_torch.models.e4e import Conv2d, Linear


def _group(**children) -> nn.Module:
    """A module holding ``children`` under their names (the HF nesting)."""
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


class LayerNorm(nn.Module):
    """LayerNorm in float32 (``weight``, ``bias``); returns float32."""

    def __init__(self, dim, eps=1e-12, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)


class ViTBlock(nn.Module):
    def __init__(self, hidden_size, num_heads, intermediate_size, policy: Policy, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        H = hidden_size
        self.num_heads = num_heads
        self.compute_dtype = policy.compute_dtype
        self.layernorm_before = LayerNorm(H, device=device)
        self.attention = _group(
            attention=_group(query=Linear(H, H, **kw), key=Linear(H, H, **kw),
                             value=Linear(H, H, **kw)),
            output=_group(dense=Linear(H, H, **kw)))
        self.layernorm_after = LayerNorm(H, device=device)
        self.intermediate = _group(dense=Linear(H, intermediate_size, **kw))
        self.output = _group(dense=Linear(intermediate_size, H, **kw))

    def forward(self, x):
        dt = self.compute_dtype
        B, N, H = x.shape
        nh = self.num_heads
        dh = H // nh
        att = self.attention.attention
        h = self.layernorm_before(x).to(dt)
        q, k, v = (lin(h).reshape(B, N, nh, dh).transpose(1, 2)
                   for lin in (att.query, att.key, att.value))
        # the logits accumulate in float32 from compute-dtype operands
        logits = q.float() @ k.float().transpose(-1, -2) / math.sqrt(dh)
        ctx = torch.softmax(logits, dim=-1).to(dt) @ v
        x = x + self.attention.output.dense(ctx.transpose(1, 2).reshape(B, N, H))
        h = self.layernorm_after(x).to(dt)
        h = F.gelu(self.intermediate.dense(h))  # HF 'gelu' is the erf form
        return x + self.output.dense(h)


class ViTClassifier(nn.Module):
    """``forward(images_nhwc) -> (B, num_labels)`` float32 logits, on
    ``device`` (``cuda`` unless given), weights drawn from ``generator``:
    dense and patch kernels LeCun normal, ``cls_token`` zero, the position
    embeddings a 0.02 truncated normal, as the JAX package initialises
    them."""

    def __init__(self, num_labels: int, image_size: int = 224, patch_size: int = 16,
                 hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, *, policy: Optional[Policy] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.policy = policy or default_policy(device)
        self.image_size = image_size
        self.patch_size = patch_size
        H = hidden_size
        kw = dict(device=device, generator=generator)
        n_tokens = (image_size // patch_size) ** 2 + 1
        self.vit = _group(
            embeddings=_group(
                cls_token=nn.Parameter(torch.zeros((1, 1, H), device=device)),
                position_embeddings=nn.Parameter(
                    truncated_normal((1, n_tokens, H), 0.02, device, generator)),
                patch_embeddings=_group(projection=Conv2d(3, H, patch_size, patch_size,
                                                          **kw))),
            encoder=_group(layer=nn.ModuleList(
                ViTBlock(H, num_heads, intermediate_size, self.policy, **kw)
                for _ in range(num_layers))),
            layernorm=LayerNorm(H, device=device))
        self.classifier = Linear(H, num_labels, **kw)

    def forward(self, x):
        dt = self.policy.compute_dtype
        emb = self.vit.embeddings
        x = emb.patch_embeddings.projection(x.to(dt))  # (B, gh, gw, H)
        B, gh, gw, H = x.shape
        x = x.reshape(B, gh * gw, H)
        x = torch.cat([emb.cls_token.to(dt).expand(B, 1, H), x], dim=1)
        x = x + emb.position_embeddings.to(dt)
        for block in self.vit.encoder.layer:
            x = block(x)
        return self.classifier(self.vit.layernorm(x)[:, 0])


def create_vit(num_labels: int, *, policy: Optional[Policy] = None, device=None,
               seed: int = 0, **kwargs) -> ViTClassifier:
    """A ViT classifier with seeded random weights, frozen, on ``device``
    (``cuda`` unless given); ``kwargs`` are ``ViTClassifier``'s widths."""
    device = resolve_device(device)
    model = ViTClassifier(num_labels, policy=policy, device=device,
                          generator=torch.Generator(device=device).manual_seed(seed),
                          **kwargs)
    return model.requires_grad_(False)
