"""Program export for serving (port of ``tpufusion/io/export.py``): the hot
inference programs, W+ decode and spatial fusion, as ``torch.export``
artifacts (``.pt2``) that a serving process loads and runs without the
model-building Python.

Parameters are ARGUMENTS of the exported program, as in the JAX package:
the program calls ``torch.func.functional_call`` on a parameter dict, so
the artifact holds the graph and the weights ship separately
(``io.params_io.save_pytree``). The styled convs export as the
``tpufusion::styled_conv`` node and, in bf16, the up convs as the
``tpufusion::styled_conv_up`` node (``ops/styled_conv.py``), so a serving
process must ``import tpufusion_torch.ops`` to register those operators
(and, on the card, build their kernels); it needs no model-building code. Export on
the device type you serve on: a program traced on ``cuda`` runs on
``cuda``.
"""

from __future__ import annotations

import torch
from torch.func import functional_call


class _Program(torch.nn.Module):
    """``fn`` as a module, for ``torch.export``. ``fn`` is kept out of the
    module's attributes, so the modules it calls are not registered and no
    weight of theirs enters the artifact."""

    def __init__(self, fn):
        super().__init__()
        self.__dict__["fn"] = fn

    def forward(self, *args):
        return self.fn(*args)


def module_params(module: torch.nn.Module) -> dict:
    """A module's parameters and buffers as one dict, in ``state_dict``
    order: the parameter argument of an exported program."""
    return {k: v.detach() for k, v in module.state_dict(keep_vars=True).items()}


def export_program(fn, example_args, path: str) -> str:
    """Export ``fn(*example_args)`` with ``torch.export`` and save it to
    ``path`` (a ``.pt2``). ``fn`` must be a function of its tensor (or
    dict-of-tensor) arguments; the artifact accepts exactly the example
    shapes, dtypes and device type."""
    exported = torch.export.export(_Program(fn), tuple(example_args), strict=False)
    # the program keeps its example inputs, parameters included: drop them,
    # so the artifact holds the graph and the weights ship separately
    exported.example_inputs = None
    torch.export.save(exported, path)
    return path


def load_program(path: str):
    """Load an exported program; returns a callable with ``.in_avals``
    (each user input's shape and dtype, flattened) and ``.platforms`` (the
    device types the program was traced on) attached. Importing
    ``tpufusion_torch.ops`` first registers its operators."""
    import tpufusion_torch.ops  # noqa: F401  (registers the tpufusion:: operators)

    exported = torch.export.load(path)
    module = exported.module()
    vals = [node.meta["val"] for node in exported.graph.nodes
            if node.op == "placeholder" and node.name in set(exported.graph_signature.user_inputs)]

    def fn(*args):
        return module(*args)

    fn.in_avals = [(tuple(v.shape), v.dtype) for v in vals]
    fn.platforms = sorted({v.device.type for v in vals})
    fn.exported = exported
    return fn


def export_decode(pipeline, path: str, *, batch: int = 1) -> str:
    """Export ``(gen_params, codes[batch, n_latent, 512]) -> image``: the
    serving form of ``decoder([codes], input_is_latent=True)``
    (`attack_main2.py:619-621`). ``gen_params`` is
    ``module_params(pipeline.generator)``."""
    gen = pipeline.generator

    def decode(params, codes):
        return functional_call(gen, params, (codes,), {"input_is_latent": True}).image

    codes = torch.zeros((batch, gen.n_latent, gen.style_dim), device=gen.device)
    return export_program(decode, (module_params(gen), codes), path)


def spatial_roles(dataset: str):
    """``(base role, [(swap keyword, role), ...])`` in swap-table order: the
    argument order of the exported spatial-fusion program."""
    from tpufusion_torch.fusion.drawer import SWAP_TABLE
    from tpufusion_torch.fusion.spatial import ROLE_MAPS

    cfg = ROLE_MAPS[dataset]
    return cfg["base"], [(k, cfg["kwargs"][k]) for k, _ in SWAP_TABLE if k in cfg["kwargs"]]


class _SpatialFusion(torch.nn.Module):
    """The drawer's generator and blender under one module, so that one
    ``functional_call`` swaps both their parameters; the forward is the
    spatial fusion of W+ latents, the mean latent an argument."""

    def __init__(self, drawer, keywords):
        super().__init__()
        self.generator, self.blender = drawer.generator, drawer.blender
        self.dataset, self.keywords = drawer.dataset, tuple(keywords)

    def forward(self, mean, base, *swaps):
        from tpufusion_torch.fusion.drawer import FusionDrawer

        view = FusionDrawer(self.dataset, self.generator, mean, self.blender)
        return view.generate_img(base, latents_type="w", **dict(zip(self.keywords, swaps)))[0]


def export_spatial_fusion(drawer, path: str) -> str:
    """Export the spatial-fusion forward of the drawer's dataset:
    ``(gen_params, blend_params, mean_latent, base_w+, *swap_w+) -> image``
    with the swaps in swap-table order (the program ``fusion()`` runs per
    group, `attack_main2.py:521-581`); ``gen_params`` and ``blend_params``
    are ``module_params`` of the generator and the blender. Returns the
    path; the argument order of the swaps is recorded in the companion
    ``<path>.roles`` text file."""
    base_role, swaps = spatial_roles(drawer.dataset)
    both = _SpatialFusion(drawer, [k for k, _ in swaps])

    def fuse(gen_params, blend_params, mean, base, *swap_latents):
        params = {**{f"generator.{k}": v for k, v in gen_params.items()},
                  **{f"blender.{k}": v for k, v in blend_params.items()}}
        return functional_call(both, params, (mean, base) + tuple(swap_latents))

    gen = drawer.generator
    # one tensor per latent argument: export would read one tensor passed
    # twice as one input
    ws = [torch.zeros((1, gen.n_latent, gen.style_dim), device=gen.device)
          for _ in range(1 + len(swaps))]
    example = (module_params(gen), module_params(drawer.blender), drawer.mean_latent, *ws)
    export_program(fuse, example, path)
    with open(path + ".roles", "w") as f:
        f.write(f"base={base_role}\n")
        for kw, role in swaps:
            f.write(f"{kw}={role}\n")
    return path
