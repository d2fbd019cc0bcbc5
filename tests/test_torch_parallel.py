"""The port's scale-out (``tpufusion_torch/parallel``) on the CPU, 32^2 FFHQ
test pipeline carried over from the JAX package, one torch thread.

Two ranks run as one module-scoped ``torch.multiprocessing`` spawn over gloo
(a ``FileStore`` in a temp dir, the loopback interface): the children run
every multi-rank check and write ``.npz`` results. Meanwhile the parent
computes the JAX oracles (the JAX sharded functions on a ``data=2`` mesh
over two of the virtual CPU devices of ``tests/conftest.py``, so both
packages pad alike) and the same port routes on a one-rank mesh, then the
single-device routes. The tests compare:

- each sharded route at world 2 against world 1 and the single-device
  route, and against the JAX sharded function. Bounds: world 1 equals the
  single-device route bit for bit (the same rows in the same batches);
  world 2 runs other batch sizes, so oneDNN may round a row differently,
  and the bounds are ``tests/test_parallel.py``'s for the same comparison
  in JAX (white-box adv 1e-4, trace rtol 1e-3; CW 1e-6 / rtol 1e-5; patch
  rtol 1e-4, atol 1e-5; group attack 1e-5; group eval 2e-4, metrics rtol
  1e-3). Against JAX: the single-device parity tests' bounds. A white-box
  pixel is held to 0.02 lr where the first step's |g| > 1e-6, and every
  pixel within Adam's bound (``tests/test_torch_whitebox.py``). A sign step
  follows the sign of its gradient, which rounding can flip where the
  gradient lies near zero or near the leaky-ReLU kink: PGD, FGSM and
  fusion-PGD pixels whose first gradient is clear of rounding (|g| > 1e-3
  of the largest) are held to 1e-6, against JAX after one step (the bound
  of ``tests/test_torch_fusion_attack.py``), world 2 against world 1 after
  two steps all but a share of 1e-3 of them (the kink share of
  ``tests/test_torch_whitebox.py``); every pixel in its eps-ball;
- ``shard_generator_params`` at ``model=2``: the decode is exact, the
  sharded leaf count is the static plan's, and a broken rule raises;
- a DCP save at world 2: an interrupted and resumed white-box run equals
  the uninterrupted one;
- ``attack_run --tiny --mesh data=2`` against the same run without
  ``--mesh``, the group-parallel branch's run folders, and
  ``invert --mesh 2`` against ``invert``.
World-1 cases in process: the mesh helpers and their errors,
``pad_batch_to_multiple`` and ``fused_image_metrics_with`` against JAX.
"""

import contextlib
import io
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpufusion_torch import parallel as P
from tpufusion_torch.attacks.cw import CWConfig, make_cw
from tpufusion_torch.attacks.fusion_attack import FusionAttackConfig
from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd
from tpufusion_torch.attacks.patch import PatchConfig
from tpufusion_torch.attacks.whitebox import WhiteboxConfig, run_whitebox
from tpufusion_torch.core.imaging import avg_pool
from tpufusion_torch.pipeline import FusionPipeline

S = 32
LR = 1e-2
N_WB = 3  # pads to 4 at world 2
G = 3  # fusion groups, pads to 4 at world 2
EPS, ALPHA = 8 / 255 * 2, 0.01 * 2
PGD_STEPS = 2
TINY_VIT = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64)
CW_CFG = dict(c=10.0, steps=4, lr=0.02)
PATCH_CFG = dict(max_count=2)
KINK_SHARE = 1e-3  # of PGD pixels that may take the other sign


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def no_process_group_left():
    """The one-rank group the parent's meshes start ends with the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared inputs and the routes every world runs
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(41)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    return dict(x=u(N_WB, S, S, 3), target=u(1, S, S, 3), groups=u(G, 5, S, S, 3),
                vit_x=rng.uniform(-0.8, 0.8, (N_WB, S, S, 3)).astype(np.float32))


def _wb_cfg():
    return WhiteboxConfig(n_iters=2, lr=LR)


def _pgd_loss(p):
    """The runner's PGD objective (encoder drift)."""
    factor = p.pool_factor

    def loss(adv, ref_codes):
        codes = p.encoder(avg_pool(adv, factor))
        return ((codes.float() - ref_codes.float()) ** 2).mean()

    return loss


def _pgd_cfg(fgsm=False, steps=PGD_STEPS):
    if fgsm:
        return PGDConfig(eps=EPS, alpha=EPS, steps=1, random_start=True)
    return PGDConfig(eps=EPS, alpha=ALPHA, steps=steps, random_start=True)


def _group_cfg(random_start, steps=PGD_STEPS):
    """The runner's arithmetic fusion PGD (``runner.py`` fusion_pgd_arith)."""
    return FusionAttackConfig(mode="arithmetic", objective="pixel", targeted=True,
                              pgd=PGDConfig(eps=EPS, alpha=ALPHA, steps=steps,
                                            random_start=random_start))


def _load(workdir):
    p = FusionPipeline.load(os.path.join(workdir, "pipeline"), device="cpu")
    from tpufusion_torch.models import classifiers as tc

    vit_fn, vit = tc.create_vit_classifier(8, device="cpu", **TINY_VIT)
    vit.load_state_dict(torch.load(os.path.join(workdir, "vit.pt")))
    vit.requires_grad_(False)
    with np.load(os.path.join(workdir, "jax_draws.npz")) as z:
        jx = {k: z[k] for k in z.files}
    return p, vit_fn, vit, jx


def _t(a):
    return torch.from_numpy(np.array(a))


def world_routes(workdir, mesh) -> dict:
    """Every sharded route on ``mesh``; numpy results."""
    p, vit_fn, vit, jx = _load(workdir)
    d = {k: _t(v) for k, v in _inputs().items()}
    out = {}
    adv, tr = P.run_whitebox_sharded(p, d["x"], d["target"], _wb_cfg(), None, mesh)
    out.update(wb_adv=adv, wb_trace=tr)
    out["wbsub_adv"], out["wbsub_trace"] = P.run_whitebox_sharded(
        p, d["x"], d["target"], _wb_cfg(), [0, 2], mesh)

    with torch.no_grad():
        ref = p.encoder(avg_pool(d["x"], p.pool_factor))
    loss = _pgd_loss(p)
    out["pgd_adv"], out["pgd_trace"] = P.run_pgd_sharded(
        loss, _pgd_cfg(), d["x"], torch.Generator().manual_seed(7), (ref,), ("batch",), mesh)
    out["pgdj_adv"], out["pgdj_trace"] = P.run_pgd_sharded(
        loss, _pgd_cfg(steps=1), d["x"], None, (ref,), ("batch",), mesh,
        start=_t(jx["pgd_start"]))
    out["fgsm_adv"], _ = P.run_pgd_sharded(
        loss, _pgd_cfg(fgsm=True), d["x"], torch.Generator().manual_seed(8), (ref,),
        ("batch",), mesh)

    labels = _t(jx["vit_labels"])
    out["cw_adv"], out["cw_l2"] = P.run_cw_sharded(
        lambda im, m: vit_fn(m, im), CWConfig(**CW_CFG), d["vit_x"], labels, (vit,), ("rep",),
        mesh)

    images = [d["x"][i : i + 1] for i in range(N_WB)]
    out["patch_canvas"], out["patch_mask"] = P.train_patch_sharded(
        p, images, torch.Generator().manual_seed(9), PatchConfig(**PATCH_CFG), mesh)
    draws = [(int(k), (int(y), int(x))) for k, y, x in jx["patch_draws"]]
    out["patchj_canvas"], _ = P.train_patch_sharded(
        p, images, None, PatchConfig(**PATCH_CFG), mesh, init_patch=_t(jx["patch_init"]),
        draws=[draws])

    tgt = d["target"][None]
    out["g_adv"], out["g_trace"] = P.make_sharded_group_fusion_attack(
        p, _group_cfg(True), mesh)(d["groups"], tgt, torch.Generator().manual_seed(10))
    out["gj_adv"], out["gj_trace"] = P.make_sharded_group_fusion_attack(
        p, _group_cfg(False, steps=1), mesh)(d["groups"], tgt, None)
    ev = P.make_sharded_group_eval(p, mesh)(d["groups"], _t(jx["group_adv"]))
    out.update({f"ev_{k}": v for k, v in ev.items()})
    return {k: v.detach().numpy() for k, v in out.items()}


def _tp_checks(workdir, mesh) -> dict:
    """``shard_generator_params`` at model=2: exact decode, counted leaves,
    a broken rule raises."""
    from torch.distributed.tensor import DTensor

    p, *_ = _load(workdir)
    z = torch.randn(2, p.generator.n_latent, 512, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = p.decode(z)
    P.shard_generator_params(p.generator, mesh, generator=p.generator)
    n_dt = sum(isinstance(q, DTensor) for q in p.generator.parameters())
    with torch.no_grad():
        got = p.decode(z)
    q, *_ = _load(workdir)
    w = q.generator.style[1].weight
    q.generator.style[1].weight = torch.nn.Parameter(w.detach().reshape(-1), requires_grad=False)
    try:
        P.shard_generator_params(q.generator, mesh, generator=q.generator)
        broken = ""
    except ValueError as e:
        broken = str(e)
    return dict(tp_ref=ref.numpy(), tp_got=got.numpy(), tp_leaves=np.int64(n_dt),
                tp_expected=np.int64(P.expected_tp_leaf_count(p.generator, 2)),
                tp_broken=np.array(broken))


def _dcp_checks(workdir, mesh, tag) -> dict:
    """A white-box run interrupted after 1 of 2 iterations and resumed from
    its DCP checkpoint (the uninterrupted run is ``wb_adv``)."""
    from tpufusion_torch.io.attack_state import run_whitebox_sharded_resumable

    p, *_ = _load(workdir)
    d = {k: _t(v) for k, v in _inputs().items()}
    ckpt = os.path.join(workdir, f"ckpt_{tag}")
    one = WhiteboxConfig(n_iters=1, lr=LR)
    _, tr1, s1 = run_whitebox_sharded_resumable(p, d["x"], d["target"], one, None, mesh, ckpt,
                                                checkpoint_every=1)
    adv, tr2, s2 = run_whitebox_sharded_resumable(p, d["x"], d["target"], _wb_cfg(), None,
                                                  mesh, ckpt, checkpoint_every=1)
    return dict(dcp_resumed=adv.numpy(), dcp_trace=torch.cat([tr1, tr2], 1).numpy(),
                dcp_starts=np.array([s1, s2]), dcp_files=np.array(sorted(os.listdir(ckpt))))


CLI = ["--dataset", "church", "--tiny", "--size", "32", "--device", "cpu",
       "--attacks", "white_box_target", "fusion_pgd_arith", "--n_iters", "2",
       "--pgd_steps", "2", "--max_num_fusion", "2", "--snapshot_every", "0"]


def _cli_runs(workdir, tag, mesh_args, invert_args):
    from tpufusion_torch.cli import attack_run, invert

    with contextlib.redirect_stdout(io.StringIO()):
        attack_run.main(CLI + mesh_args + ["--save_dir", os.path.join(workdir, f"cli_{tag}")])
        invert.main(["--images_dir", os.path.join(workdir, "faces"), "--tiny", "--device", "cpu",
                     "--latents_only", "--batch", "3",
                     "--save_dir", os.path.join(workdir, f"inv_{tag}")] + invert_args)


def _worker(rank, workdir):
    """Ranks 0 and 1 form the two-rank world; process 2 runs the same
    routes as a one-rank world beside them."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    if rank < 2:
        store = dist.FileStore(os.path.join(workdir, "store"), 2)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        mesh = P.create_mesh("cpu")
        out = world_routes(workdir, mesh)
        if rank < 2:
            out.update(_tp_checks(workdir, P.create_mesh("cpu", data=1, model=2)))
            out.update(_dcp_checks(workdir, mesh, "w2"))
            _cli_runs(workdir, "w2", ["--mesh", "data=2"], ["--mesh", "2"])
        else:  # the CLIs without a mesh
            _cli_runs(workdir, "w1", [], [])
        name = f"world2_rank{rank}" if rank < 2 else "world1"
        np.savez(os.path.join(workdir, f"{name}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: JAX oracles, world 1, single device
# ---------------------------------------------------------------------------


def _square_draw(key, size, side):
    """JAX's square_transform draw from ``key`` (`patch.py:115-122`)."""
    import jax

    krot, kloc = jax.random.split(key)
    k = int(jax.random.randint(krot, (), 0, 4))
    pos = jax.random.randint(kloc, (2,), 0, size - side + 1)
    return (k,) + tuple(int(v) for v in np.asarray(pos))


def _write_faces(directory, n=5):
    from PIL import Image

    os.makedirs(directory)
    rng = np.random.default_rng(5)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
            os.path.join(directory, f"{i:02d}.png"))


def _group_adv():
    """Fixed adversarial groups for the group evaluation: the groups moved
    by a seeded draw in the eps-ball."""
    groups = _inputs()["groups"]
    move = np.random.default_rng(43).uniform(-EPS, EPS, groups.shape).astype(np.float32)
    return np.clip(groups + move, -1.0, 1.0)


def _jax_draws(jvit, workdir):
    """The JAX package's draws that the port's JAX-parity runs take (its
    PGD start, initial patch and placements) and the ViT's labels, written
    for the children."""
    import jax
    import jax.numpy as jnp

    from tpufusion.attacks import patch as jpa
    from tpufusion.attacks import pgd as jpgd

    d = {k: jnp.asarray(v) for k, v in _inputs().items()}
    j_fn, jv = jvit
    pcfg = jpgd.PGDConfig(eps=EPS, alpha=ALPHA, steps=PGD_STEPS, random_start=True)
    draws = dict(pgd_start=np.asarray(jpgd.pgd_random_start(d["x"], _pgd_key(), pcfg)),
                 vit_labels=np.asarray(jnp.argmax(jax.jit(j_fn)(jv, d["vit_x"]), -1)),
                 group_adv=_group_adv())
    key, kinit = jax.random.split(_patch_key())
    init = jpa.init_patch_square(S, jpa.PatchConfig(**PATCH_CFG).patch_frac, kinit)
    _, k = jax.random.split(key)
    draws["patch_init"] = np.asarray(init)
    draws["patch_draws"] = np.array([_square_draw(kk, S, init.shape[0])
                                     for kk in jax.random.split(k, 4)])
    np.savez(os.path.join(workdir, "jax_draws.npz"), **draws)
    return draws


def _pgd_key():
    import jax

    return jax.random.key(21)


def _patch_key():
    import jax

    return jax.random.key(23)


def _jax_oracles(jp, jvit, draws):
    """The JAX sharded functions on data=2."""
    import jax
    import jax.numpy as jnp

    from tpufusion import parallel as JP
    from tpufusion.attacks import fusion_attack as jfa
    from tpufusion.attacks import patch as jpa
    from tpufusion.attacks import pgd as jpgd
    from tpufusion.attacks import whitebox as jwb
    from tpufusion.attacks.cw import CWConfig as JCWConfig
    from tpufusion.core.imaging import avg_pool as javg

    mesh = JP.create_mesh(jax.devices()[:2])
    d = {k: jnp.asarray(v) for k, v in _inputs().items()}
    j_fn, jv = jvit
    out = {}
    wcfg = jwb.WhiteboxConfig(lr=LR, n_iters=2)
    out["wb_adv"], out["wb_trace"] = JP.run_whitebox_sharded(jp, d["x"], d["target"], wcfg,
                                                             None, mesh)
    enc, factor = jp.encode_fn(), jp.pool_factor

    def loss(adv, enc_params, ref_codes):
        return jnp.mean((enc(enc_params, javg(adv, factor)) - ref_codes) ** 2)

    ref = jax.lax.stop_gradient(jp.encode(d["x"]))
    pcfg = jpgd.PGDConfig(eps=EPS, alpha=ALPHA, steps=1, random_start=True)
    out["pgd_adv"], out["pgd_trace"] = JP.run_pgd_sharded(
        loss, pcfg, d["x"], _pgd_key(), (jp.enc_vars, ref), ("rep", "batch"), mesh)

    labels = jnp.asarray(draws["vit_labels"])
    out["cw_adv"], out["cw_l2"] = JP.run_cw_sharded(
        lambda im, prm: j_fn(prm, im), JCWConfig(**CW_CFG), d["vit_x"], labels, (jv,),
        ("rep",), mesh)

    out["patch_canvas"], out["patch_mask"] = JP.train_patch_sharded(
        jp, [d["x"][i : i + 1] for i in range(N_WB)], _patch_key(),
        jpa.PatchConfig(**PATCH_CFG), mesh)

    tgt = d["target"][None]
    cfg = jfa.FusionAttackConfig(mode="arithmetic", objective="pixel", targeted=True,
                                 pgd=jpgd.PGDConfig(eps=EPS, alpha=ALPHA, steps=1,
                                                    random_start=False))
    out["gj_adv"], out["gj_trace"] = JP.make_sharded_group_fusion_attack(jp, cfg, mesh)(
        d["groups"], tgt, jax.random.key(25))
    ev = JP.make_sharded_group_eval(jp, mesh)(d["groups"], jnp.asarray(draws["group_adv"]))
    out.update({f"ev_{k}": v for k, v in ev.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _single_device(workdir) -> dict:
    """The single-device routes the sharded ones are held to."""
    p, vit_fn, vit, jx = _load(workdir)
    d = {k: _t(v) for k, v in _inputs().items()}
    out = {}
    wide = d["target"].expand(N_WB, -1, -1, -1).contiguous()
    adv, tr = run_whitebox(p, d["x"], wide, _wb_cfg())
    out.update(wb_adv=adv, wb_trace=tr["total"])
    with torch.no_grad():
        ref = p.encoder(avg_pool(d["x"], p.pool_factor))
    out["pgd_adv"], out["pgd_trace"] = make_pgd(_pgd_loss(p), _pgd_cfg())(
        d["x"], torch.Generator().manual_seed(7), ref)
    out["fgsm_adv"], _ = make_pgd(_pgd_loss(p), _pgd_cfg(fgsm=True))(
        d["x"], torch.Generator().manual_seed(8), ref)
    out["cw_adv"], out["cw_l2"] = make_cw(lambda im, m: vit_fn(m, im), CWConfig(**CW_CFG))(
        d["vit_x"], _t(jx["vit_labels"]), vit)
    x = d["x"].clone().requires_grad_(True)
    from tpufusion_torch.attacks import whitebox as wb

    ref_b = wb._make_ref(p)(d["x"], wide)
    total, _ = wb._make_loss(p, wb.PRESET_ATTACK_MAIN, per_image=True)(x, ref_b)
    out["wb_first_grad"] = torch.autograd.grad(total.sum(), x)[0]

    # each sign step's first gradient, for the masks of _held_to_signs
    def grad_at(loss, start, *args):
        a = start.detach().clone().requires_grad_(True)
        return torch.autograd.grad(loss(a, *args), a)[0]

    from tpufusion_torch.attacks.fusion_attack import make_fusion_loss
    from tpufusion_torch.attacks.pgd import pgd_random_start
    from tpufusion_torch.core.prng import split_generator

    loss = _pgd_loss(p)
    for k, cfg, seed in (("pgd", _pgd_cfg(), 7), ("fgsm", _pgd_cfg(fgsm=True), 8)):
        start = pgd_random_start(d["x"], torch.Generator().manual_seed(seed), cfg)
        out[f"{k}_grad"] = grad_at(loss, start, ref)
    out["pgdj_grad"] = grad_at(loss, _t(jx["pgd_start"]), ref)
    floss = make_fusion_loss(p, _group_cfg(True))
    root = torch.Generator().manual_seed(10)
    gens = [split_generator(root) for _ in range(G)]
    out["g_grad"] = torch.stack([
        grad_at(floss, pgd_random_start(d["groups"][g], gens[g], _group_cfg(True).pgd),
                d["target"]) for g in range(G)])
    out["gj_grad"] = torch.stack([grad_at(floss, d["groups"][g], d["target"])
                                  for g in range(G)])
    return {k: v.detach().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def pipelines():
    """The JAX package's 32^2 test pipeline and the port's on its weights."""
    import jax

    from tests.torch_pipelines import port_of
    from tpufusion.pipeline import create_test_pipeline

    jp = create_test_pipeline("ffhq", jax.random.key(0), size=S)
    return jp, port_of(jp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, pipelines):
    from tests.torch_pipelines import np_tree
    from tpufusion.models import classifiers as jc
    from tpufusion_torch.io.convert import state_dict_to_torch, vit_state_from_jax
    from tpufusion_torch.models import classifiers as tc

    workdir = str(tmp_path_factory.mktemp("parallel"))
    jp, tp = pipelines
    tp.save(os.path.join(workdir, "pipeline"))
    j_fn, jv = jc.create_vit_classifier(8, seed=5, **TINY_VIT)
    jv = np_tree(jv)
    _, tm = tc.create_vit_classifier(8, device="cpu", **TINY_VIT)
    torch.save(tm.state_dict() | state_dict_to_torch(vit_state_from_jax(jv)),
               os.path.join(workdir, "vit.pt"))
    _write_faces(os.path.join(workdir, "faces"))
    draws = _jax_draws((j_fn, jv), workdir)

    # the two ranks, and a one-rank world with the CLIs without a mesh, run
    # while the parent runs the JAX oracles, the single-device routes and
    # the one-rank DCP resume
    ctx = torch.multiprocessing.start_processes(_worker, args=(workdir,), nprocs=3,
                                                join=False, start_method="spawn")
    jax_out = _jax_oracles(jp, (j_fn, jv), draws)
    single = _single_device(workdir)
    dcp1 = _dcp_checks(workdir, P.create_mesh("cpu", data=1), "w1")
    deadline = time.time() + 600
    while not ctx.join(timeout=5):
        assert time.time() < deadline, "the two-rank spawn did not finish"
    w2 = [dict(np.load(os.path.join(workdir, f"world2_rank{r}.npz"))) for r in (0, 1)]
    w1 = dict(np.load(os.path.join(workdir, "world1.npz")), **dcp1)
    return dict(workdir=workdir, jax=jax_out, w1=w1, w2=w2[0], w2r1=w2[1], single=single)


# ---------------------------------------------------------------------------
# world 1, in process
# ---------------------------------------------------------------------------


def test_mesh_helpers_and_errors():
    from torch.distributed.tensor import Replicate, Shard

    mesh = P.create_mesh("cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert tuple(P.create_mesh(torch.device("cpu"), data=1).shape) == (1, 1)
    assert P.batch_sharding(mesh, 4) == (Shard(0), Replicate())
    assert P.replicate(mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="requested model=2"):
        P.create_mesh("cpu", model=2)
    with pytest.raises(ValueError, match="cannot build a data=2 x model=1 mesh"):
        P.create_mesh("cpu", data=2)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(P.sharding.gather_rows(mesh, P.sharding.local_rows(mesh, x)), x)


def test_a_mesh_refuses_a_group_on_another_backend():
    """A ``cuda`` mesh in a process whose group runs gloo raises, where it
    would build the mesh on gloo."""
    P.create_mesh("cpu")
    assert dist.get_backend() == "gloo"
    with pytest.raises(ValueError, match="needs a nccl process group, but the initialised "
                                         "one runs gloo"):
        P.sharding.init_process_group("cuda")
    P.sharding.init_process_group("cpu")  # the group's own backend: kept
    assert dist.is_initialized()


@pytest.mark.parametrize("n,multiple", [(5, 2), (4, 2), (1, 4), (3, 8), (7, 3)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    import jax.numpy as jnp

    from tpufusion.parallel import pad_batch_to_multiple as j_pad

    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, n_real = P.pad_batch_to_multiple(torch.from_numpy(x), multiple)
    want, j_real = j_pad(jnp.asarray(x), multiple)
    assert n_real == j_real == n and got.shape[0] % multiple == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_image_metrics_with_matches_jax(pipelines):
    from tpufusion.eval.metrics import fused_image_metrics_with as j_metrics
    from tpufusion_torch.eval import fused_image_metrics, fused_image_metrics_with

    jp, tp = pipelines
    rng = np.random.default_rng(3)
    benign = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
    fused = rng.uniform(-1, 1, (4, S, S, 3)).astype(np.float32)
    want = j_metrics(jp._vgg, jp.vgg_vars, jp.pool_factor, benign, fused)
    got = fused_image_metrics_with(lambda m, x: m(x), tp.vgg, tp.pool_factor,
                                   _t(benign), _t(fused))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4)
    for g, w in zip(fused_image_metrics(tp, _t(benign), _t(fused)), got):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the routes: world 2 / world 1 / single device / JAX
# ---------------------------------------------------------------------------


def _mask(runs):
    mask = np.abs(runs["single"]["wb_first_grad"]) > 1e-6
    assert mask.mean() > 0.5
    return mask


def _held_wb(got, want, mask, what):
    """White-box pixels: within 0.02 lr where the first step's |g| > 1e-6;
    every pixel within Adam's bound of lr a step of the other run."""
    np.testing.assert_allclose(got[mask], want[mask], atol=0.02 * LR, rtol=0, err_msg=what)
    assert np.abs(got - want).max() <= 2 * LR * _wb_cfg().n_iters, what


def test_whitebox_world1_is_the_single_device_route(runs):
    for k in ("wb_adv", "wb_trace"):
        np.testing.assert_array_equal(runs["w1"][k], runs["single"][k], err_msg=k)


def test_whitebox_world2_matches_world1(runs):
    w1, w2 = runs["w1"], runs["w2"]
    assert w2["wb_adv"].shape == (N_WB, S, S, 3) and w2["wb_trace"].shape == (N_WB, 2)
    _held_wb(w2["wb_adv"], w1["wb_adv"], _mask(runs), "world 2")
    np.testing.assert_allclose(w2["wb_trace"], w1["wb_trace"], rtol=1e-3, atol=1e-4)
    assert np.abs(w2["wb_adv"] - _inputs()["x"]).max() > 0.5 * LR


def test_whitebox_matches_jax(runs):
    mask, j = _mask(runs), runs["jax"]
    for world in ("w1", "w2"):
        _held_wb(runs[world]["wb_adv"], j["wb_adv"], mask, world)
        np.testing.assert_allclose(runs[world]["wb_trace"], j["wb_trace"], atol=2e-4,
                                   rtol=2e-4, err_msg=world)


def test_whitebox_which_adv_subset(runs):
    x, mask = _inputs()["x"], _mask(runs)
    for world in ("w1", "w2"):
        got = runs[world]
        np.testing.assert_array_equal(got["wbsub_adv"][1], x[1])
        assert got["wbsub_trace"].shape == (2, 2)
        _held_wb(got["wbsub_adv"][[0, 2]], runs["w1"]["wb_adv"][[0, 2]], mask[[0, 2]], world)


def _held_to_signs(runs, key, got, want, x, what, share=KINK_SHARE):
    """Sign-step pixels whose first gradient is clear of rounding (|g| >
    1e-3 of the largest): equal to 1e-6 but for a ``share`` of them that
    took the other sign of a later gradient near zero or near the kink;
    every pixel in the eps-ball of its input and in [-1, 1]."""
    g = np.abs(runs["single"][f"{key}_grad"])
    mask = g > 1e-3 * g.max()
    assert mask.mean() > 0.5, (what, mask.mean())
    off = (np.abs(got - want) > 1e-6) & mask
    assert off.sum() <= share * mask.sum(), (what, off.sum() / mask.sum())
    assert np.abs(got - x).max() <= EPS + 1e-6 and np.abs(got).max() <= 1.0, what


@pytest.mark.parametrize("route", ["pgd", "fgsm"])
def test_pgd_world1_and_world2_match_the_single_device_route(runs, route):
    k, x = f"{route}_adv", _inputs()["x"]
    np.testing.assert_array_equal(runs["w1"][k], runs["single"][k])
    _held_to_signs(runs, route, runs["w2"][k], runs["single"][k], x, route)
    assert np.abs(runs["w2"][k] - x).max() > 0.5 * ALPHA
    if route == "pgd":  # one rank: the single-device batch's loss
        np.testing.assert_array_equal(runs["w1"]["pgd_trace"], runs["single"]["pgd_trace"])


def test_pgd_matches_jax_from_its_start(runs):
    j, x = runs["jax"], _inputs()["x"]
    for world in ("w1", "w2"):
        _held_to_signs(runs, "pgdj", runs[world]["pgdj_adv"], j["pgd_adv"], x, world, share=0)
    # both traces are the loss of the batch padded to data=2 (log only)
    np.testing.assert_allclose(runs["w2"]["pgdj_trace"], j["pgd_trace"], rtol=2e-4, atol=1e-7)


def test_cw_matches_single_device_and_jax(runs):
    single, j = runs["single"], runs["jax"]
    won = np.isfinite(single["cw_l2"])
    assert won.any()
    for world in ("w1", "w2"):
        got = runs[world]
        np.testing.assert_array_equal(np.isfinite(got["cw_l2"]), won)
        np.testing.assert_allclose(got["cw_adv"], single["cw_adv"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["cw_l2"][won], single["cw_l2"][won], rtol=1e-5)
        np.testing.assert_array_equal(np.isfinite(j["cw_l2"]), won)
        np.testing.assert_allclose(got["cw_l2"][won], j["cw_l2"][won], rtol=1e-5)
        np.testing.assert_allclose(got["cw_adv"], j["cw_adv"], atol=1e-5, rtol=0)


def test_patch_world2_matches_world1(runs):
    w1, w2 = runs["w1"], runs["w2"]
    np.testing.assert_array_equal(w2["patch_mask"], w1["patch_mask"])
    np.testing.assert_allclose(w2["patch_canvas"], w1["patch_canvas"], rtol=1e-4, atol=1e-5)
    x = _inputs()["x"]
    inside = w2["patch_mask"] > 0
    assert x.min() - 1e-6 <= w2["patch_canvas"][inside].min()
    assert w2["patch_canvas"][inside].max() <= x.max() + 1e-6


def test_patch_matches_jax(runs):
    j = runs["jax"]
    for world in ("w1", "w2"):
        np.testing.assert_array_equal(runs[world]["patch_mask"], j["patch_mask"])
        np.testing.assert_allclose(runs[world]["patchj_canvas"], j["patch_canvas"],
                                   rtol=1e-4, atol=1e-5, err_msg=world)


def test_group_attack_world2_matches_world1(runs):
    w1, w2, groups = runs["w1"], runs["w2"], _inputs()["groups"]
    assert w2["g_adv"].shape == (G, 5, S, S, 3) and w2["g_trace"].shape == (G, PGD_STEPS)
    _held_to_signs(runs, "g", w2["g_adv"], w1["g_adv"], groups, "world 2")
    np.testing.assert_allclose(w2["g_trace"], w1["g_trace"], rtol=1e-4)
    # each group drew its own start
    assert not np.allclose(w2["g_adv"][0] - groups[0], w2["g_adv"][1] - groups[1])


def test_group_attack_matches_jax(runs):
    j, groups = runs["jax"], _inputs()["groups"]
    for world in ("w1", "w2"):
        _held_to_signs(runs, "gj", runs[world]["gj_adv"], j["gj_adv"], groups, world, share=0)
        np.testing.assert_allclose(runs[world]["gj_trace"], j["gj_trace"], rtol=2e-4,
                                   atol=1e-7, err_msg=world)


def test_group_eval_matches_world1_and_jax(runs):
    from tpufusion_torch.parallel.sharding import GROUP_EVAL_KEYS

    w1, w2, j = runs["w1"], runs["w2"], runs["jax"]
    for k in GROUP_EVAL_KEYS:
        a, b, c = w2[f"ev_{k}"], w1[f"ev_{k}"], np.asarray(j[f"ev_{k}"])
        assert a.shape == c.shape and a.shape[0] == G, k
        if k == "noise":
            np.testing.assert_allclose(a, b, rtol=1e-5)
            np.testing.assert_allclose(a, c, rtol=1e-5)
        elif k.startswith(("b_", "part_")):
            np.testing.assert_allclose(a, b, atol=2e-4, err_msg=k)
            np.testing.assert_allclose(a, c, atol=2e-4, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=k)
            np.testing.assert_allclose(a, c, rtol=1e-3, atol=1e-4, err_msg=k)


def test_every_rank_gets_the_whole_result(runs):
    for k in ("wb_adv", "pgd_adv", "cw_adv", "cw_l2", "patch_canvas", "g_adv", "ev_part_sp"):
        np.testing.assert_array_equal(runs["w2r1"][k], runs["w2"][k], err_msg=k)


def test_tensor_parallel_generator_is_exact(runs):
    w2 = runs["w2"]
    np.testing.assert_array_equal(w2["tp_got"], w2["tp_ref"])
    assert int(w2["tp_leaves"]) == int(w2["tp_expected"]) > 0
    assert "static plan expects" in str(w2["tp_broken"])


def test_dcp_resume_equals_the_uninterrupted_run(runs):
    for world in ("w1", "w2"):
        got = runs[world]
        assert list(got["dcp_starts"]) == [0, 1]
        np.testing.assert_array_equal(got["dcp_resumed"], got["wb_adv"])
        np.testing.assert_array_equal(got["dcp_trace"], got["wb_trace"])
        assert list(got["dcp_files"]) == ["step_2"]  # older checkpoints pruned


def _artifact(root, attack, name):
    """``name``.npz of each run folder of ``attack``, in run order."""
    from tpufusion_torch.io import ArtifactStore

    dirs = sorted(d for d in os.listdir(root) if attack in d)
    return [ArtifactStore.load(os.path.join(root, d, "adversarial", f"{name}.npz"))
            for d in dirs]


def test_attack_run_mesh_matches_the_run_without(runs):
    """The white-box attack of ``attack_run --mesh data=2`` against the same
    run without a mesh, per group (the fusion PGD's random starts come from
    other draws with a mesh: the group-parallel branch splits them)."""
    wd = runs["workdir"]
    one, two = (os.path.join(wd, f"cli_{t}", "church") for t in ("w1", "w2"))
    a1, a2 = (_artifact(r, "white_box_target", "all_adv_inputs") for r in (one, two))
    assert len(a1) == len(a2) == 2
    for g1, g2 in zip(a1, a2):  # lr 1e-4: the Adam bound
        np.testing.assert_allclose(g2, g1, atol=0.2 * 1e-4, rtol=0)
        assert np.abs(g2 - g1).max() < 1e-5 or np.abs(g2).max() <= 1.0
    for d in os.listdir(two):
        if d.endswith("white_box_target"):
            assert os.path.exists(os.path.join(two, d, "loss_white_box_target.txt"))


def test_attack_run_group_parallel_writes_every_group(runs):
    import json

    root = os.path.join(runs["workdir"], "cli_w2", "church")
    dirs = sorted(d for d in os.listdir(root) if "fusion_pgd_arith" in d)
    assert len(dirs) == 2
    for d in dirs:
        with open(os.path.join(root, d, "results.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert len(rows) == 1 and np.isfinite(rows[0]["noise_mse"])
        assert all(np.isfinite(rows[0][k]).all() for k in ("cri_spatial", "ssim_arith"))
        assert os.path.exists(os.path.join(root, d, "loss_fusion_pgd_arith.txt"))
    for adv, x in zip(_artifact(root, "fusion_pgd_arith", "all_adv_inputs"),
                      _artifact(root, "fusion_pgd_arith", "all_inputs")):
        assert adv.shape == x.shape == (3, S, S, 3)
        assert np.abs(adv - x).max() <= EPS + 1e-6 and np.abs(adv).max() <= 1.0


def test_invert_mesh_matches_invert(runs):
    wd = runs["workdir"]
    got, want = (np.load(os.path.join(wd, f"inv_{t}", "latents.npz"))["latents"]
                 for t in ("w2", "w1"))
    assert got.shape == want.shape == (5, 8, 512)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
