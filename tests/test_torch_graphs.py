"""The step programs (``tpufusion_torch/core/graphs.py``) on the CPU, where
each program calls its step body on static buffers (on the card it replays
a CUDA graph of it; ``tests/test_torch_cuda.py`` holds those):

- the static-buffer bodies equal the eager loops (``pgd_eager``,
  ``whitebox.run_eager``, ``cw_eager``) bit for bit: PGD (arithmetic pixel,
  spatial 'vgg'), white-box (batch mean, per image, snapshots under both
  executors, ``grad_accum=2``), classifier PGD and CW; a second call of one attack object
  reuses its program;
- both loops agree with the JAX package's ``lax.scan`` traces at atol =
  rtol = 2e-4 (PGD 5 steps, the white-box batch-mean terms over 3);
- the Adam bias-correction table equals ``bias_corrections(t)`` bit for
  bit (t = 1..200, and every step past the table's end rounds to (1, 1));
  ``adam_update_plain`` from a table row equals the float path;
- a program's warm-up steps, capture and replays and their launch
  bookkeeping, with a stub graph; the cache keys on where the modules'
  tensors live and on the backend flags;
- ``WhiteboxConfig.execution`` is validated and the runner's
  ``resolve_whitebox_execution`` decides the executor (``grad_accum``
  does not).

32^2 pipelines on the JAX package's test weights, torch on one thread.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_pipelines import one_torch_thread, port_of  # noqa: F401
from tpufusion.attacks import whitebox as jwb
from tpufusion.attacks.fusion_attack import make_fused_image_fn as j_fused_fn
from tpufusion.attacks.pgd import PGDConfig as JPGDConfig
from tpufusion.attacks.pgd import make_pgd as j_make_pgd
from tpufusion.pipeline import create_test_pipeline
from tpufusion_torch import ops
from tpufusion_torch.attacks import whitebox as wb
from tpufusion_torch.attacks.cw import CWConfig, cw_eager, make_cw
from tpufusion_torch.attacks.fusion_attack import (
    FusionAttackConfig, make_fusion_attack, make_fusion_loss)
from tpufusion_torch.attacks.pgd import PGDConfig, make_pgd, pgd_eager, pgd_random_start
from tpufusion_torch.core import graphs
from tpufusion_torch.models import classifiers as tc
from tpufusion_torch.models.resnet import ResNet
from tpufusion_torch.ops import adam_update as au

TOL = dict(atol=2e-4, rtol=2e-4)
EPS, ALPHA, LR = 16 / 255, 0.02, 1e-2


@pytest.fixture(scope="module")
def pipes():
    jp = create_test_pipeline("ffhq", jax.random.key(0), size=32)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    start = np.clip(x[:2] + rng.uniform(-EPS, EPS, x[:2].shape), -1, 1).astype(np.float32)
    return jp, port_of(jp), x, target, start


@pytest.fixture(scope="module")
def jax_traces(pipes):
    """The JAX package's scanned PGD (5 steps, pixel objective, from
    ``start``) and white-box (batch mean, 3 iterations) runs."""
    jp, _, x, target, start = pipes
    fused_j = j_fused_fn(jp, "arithmetic")

    def j_loss(adv, params_, tgt):
        d = fused_j(params_, adv).astype(jnp.float32) - tgt.astype(jnp.float32)
        return jnp.mean(d * d)

    params = dict(enc=jp.enc_vars, gen=jp.drawer.gen_vars, blend=jp.drawer.blend_params,
                  vgg=jp.vgg_vars)
    _, pgd_trace = j_make_pgd(j_loss, JPGDConfig(eps=EPS, alpha=ALPHA, steps=5, targeted=True),
                              external_start=True)(
        jnp.asarray(x[:2]), jnp.asarray(start), params, jnp.asarray(target))
    _, wb_trace = jwb.make_whitebox_attack(jp, jwb.WhiteboxConfig(lr=LR, n_iters=3))(
        jnp.asarray(x[:2]), jnp.asarray(target))
    return np.asarray(pgd_trace), {k: np.asarray(v) for k, v in wb_trace.items()}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal_trees(u, v)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("mode,objective", [("arithmetic", "pixel"), ("spatial", "vgg")])
def test_pgd_program_equals_the_eager_loop(pipes, mode, objective):
    _, tp, x, target, _ = pipes
    xi = torch.from_numpy(x[:2] if mode == "arithmetic" else x)
    tt = torch.from_numpy(target)
    cfg = FusionAttackConfig(mode=mode, objective=objective,
                             pgd=PGDConfig(eps=EPS, alpha=ALPHA, steps=3))
    attack = make_fusion_attack(tp, cfg)
    adv, trace = attack(xi, tt, torch.Generator().manual_seed(3))
    pcfg = dataclasses.replace(cfg.pgd, targeted=True)
    start = pgd_random_start(xi, torch.Generator().manual_seed(3), pcfg)
    want = pgd_eager(make_fusion_loss(tp, cfg), pcfg, xi, start, tt)
    _equal_trees((adv, trace), want)
    assert trace.dtype == torch.float32 and trace.shape == (3,)
    # a second call reuses the program: new inputs copied in, same bits
    again = attack(xi, tt, torch.Generator().manual_seed(3))
    _equal_trees(again, want)
    progs = list(attack.programs)
    assert len(progs) == 1 and progs[0].replays == 6 and progs[0].graph is None


WB_CASES = {
    "batch_mean": (False, dict()),
    "per_image": (True, dict()),
    "snapshots_stepwise": (True, dict(snapshot_every=2, execution="stepwise")),
    "grad_accum_2_snapshots_scan": (True, dict(grad_accum=2, snapshot_every=2)),
}


@pytest.mark.parametrize("case", list(WB_CASES))
def test_whitebox_program_equals_the_eager_loop(pipes, case):
    _, tp, x, target, _ = pipes
    per_image, kw = WB_CASES[case]
    cfg = wb.WhiteboxConfig(lr=LR, n_iters=3, **kw)
    imgs = torch.from_numpy(x[:3])  # chunks of 2 pad the odd batch by wrap
    tt = torch.from_numpy(target)
    make = wb.make_per_image_whitebox if per_image else wb.make_whitebox_attack
    got = make(tp, cfg)(imgs, tt)
    want = wb.run_eager(tp, cfg, imgs, tt, per_image=per_image)
    _equal_trees(got, want)
    assert got[1]["total"].shape == ((3, 3) if per_image else (3,))
    if "snapshot_every" in kw:  # one frame, after the third step
        assert got[2]["adv_input"].shape == (1, 3, 32, 32, 3)


def test_cw_program_equals_the_eager_loop():
    model = ResNet(2, width=8, device="cpu", generator=torch.Generator().manual_seed(4))
    model.requires_grad_(False)
    fn = tc.resnet_logits_fn(32)
    x = torch.rand((4, 48, 48, 3), generator=torch.Generator().manual_seed(5)) * 1.6 - 0.8
    with torch.no_grad():
        labels = fn(model, x).argmax(-1)
    cfg = CWConfig(c=100.0, steps=10)
    attack = make_cw(lambda im, m: fn(m, im), cfg)
    got = attack(x, labels, model)
    want = cw_eager(lambda im, m: fn(m, im), cfg, x, labels, model)
    _equal_trees(got, want)
    assert torch.isfinite(got[1]).any()
    # the program is keyed by the classifier's identity
    other = ResNet(2, width=8, device="cpu", generator=torch.Generator().manual_seed(6))
    other.requires_grad_(False)
    attack(x, labels, other)
    assert len(list(attack.programs)) == 2
    attack.programs.release()
    assert list(attack.programs) == []


@pytest.mark.parametrize("loop", ["program", "eager"])
def test_pgd_loops_match_jax_trace(pipes, jax_traces, loop):
    _, tp, x, target, start = pipes
    cfg = FusionAttackConfig()
    pcfg = dataclasses.replace(cfg.pgd, eps=EPS, alpha=ALPHA, steps=5, targeted=True)
    xt, tt, st = (torch.from_numpy(a) for a in (x[:2], target, start))
    loss = make_fusion_loss(tp, cfg)
    if loop == "program":
        _, trace = make_pgd(loss, pcfg, external_start=True)(xt, st, tt)
    else:
        _, trace = pgd_eager(loss, pcfg, xt, st, tt)
    np.testing.assert_allclose(trace.numpy(), jax_traces[0], **TOL)


@pytest.mark.parametrize("loop", ["program", "eager"])
def test_whitebox_loops_match_jax_trace(pipes, jax_traces, loop):
    _, tp, x, target, _ = pipes
    cfg = wb.WhiteboxConfig(lr=LR, n_iters=3)
    imgs, tt = torch.from_numpy(x[:2]), torch.from_numpy(target)
    if loop == "program":
        _, trace = wb.make_whitebox_attack(tp, cfg)(imgs, tt)
    else:
        _, trace = wb.run_eager(tp, cfg, imgs, tt, per_image=False)
    want = jax_traces[1]
    assert sorted(trace) == sorted(want)
    for k, v in trace.items():
        np.testing.assert_allclose(v.numpy(), want[k], **TOL, err_msg=k)


def test_bias_table_holds_the_host_corrections():
    table = au.bias_table("cpu")
    assert table.dtype == torch.float32 and tuple(table.shape) == (au.TABLE_ROWS, 2)
    for t in range(1, 201):
        assert tuple(table[t - 1].tolist()) == au.bias_corrections(t), t
    # the last row is (1, 1) and every later step rounds to it: the kernel
    # reads row min(count, rows - 1)
    assert tuple(table[-1].tolist()) == (1.0, 1.0)
    assert tuple(table[-2].tolist()) != (1.0, 1.0)
    for t in (au.TABLE_ROWS, au.TABLE_ROWS + 1, 10 ** 5, 10 ** 7):
        assert au.bias_corrections(t) == (1.0, 1.0), t
    assert int(au.step_index("cpu", 7)) == 7
    assert int(au.step_index("cpu", 10 ** 6)) == au.TABLE_ROWS - 1


@pytest.mark.parametrize("count", [1, 2, 50, 200])
def test_adam_plain_from_the_table_equals_the_float_path(count):
    rng = np.random.default_rng(count)
    x, g, mu = (torch.from_numpy(rng.standard_normal((2, 7, 5, 3)).astype(np.float32))
                for _ in range(3))
    nu = mu.square()
    row = au.bias_table("cpu")[count - 1]
    a = au.adam_update_plain(x.clone(), g, mu.clone(), nu.clone(), LR, row[0], row[1])
    b = au.adam_update_plain(x.clone(), g, mu.clone(), nu.clone(), LR,
                             *au.bias_corrections(count))
    _equal_trees(a, b)


def test_fused_adam_device_count_equals_the_host_count():
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (1, 6, 6, 3)).astype(np.float32))
    grads = [torch.from_numpy(rng.standard_normal(x0.shape).astype(np.float32))
             for _ in range(4)]
    xa, xb = x0.clone(), x0.clone()
    sa, sb = au.adam_init(xa), au.adam_init(xb, on_device=True)
    for g in grads:
        xa, sa = au.fused_adam(xa, g, sa, LR)
        xb, sb2 = au.fused_adam(xb, g, sb, LR)
        assert sb2 is sb  # a device count advances in place
    assert sa["count"] == 4 and sb["count"].dtype == torch.int32 and int(sb["count"]) == 4
    _equal_trees((xa, sa["mu"], sa["nu"]), (xb, sb["mu"], sb["nu"]))


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts replays."""

    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1

    def pool(self):
        return "pool"

    def reset(self):
        pass


def _stub_cuda(monkeypatch, captured):
    """Make a program's warm-up and capture run on the CPU: streams,
    synchronize and the capture context are stubs; the capture context runs
    the body once (its wrappers count launches, as they do at capture)."""
    stream = type("S", (), {"wait_stream": lambda self, other: None})()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)

    @contextlib.contextmanager
    def graph(g, pool=None):
        captured.append(pool)
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)


def _on_card(prog):
    """``prog`` with its device read as the card's (CPU tensors stand in)."""
    prog.device = torch.device("cuda")
    return prog


def test_replays_add_the_captured_launches(monkeypatch):
    captured = []
    _stub_cuda(monkeypatch, captured)
    ops.reset_launch_counts()
    calls = []

    def body(state, inputs):
        # what a step's wrappers count: 9 styled convs, one pixel update
        calls.append(state["x"].data_ptr())
        ops.add_launch_counts({"styled_conv": 9, "pgd_update": 1})
        state["x"].add_(inputs["d"])

    state = dict(x=torch.zeros(3))
    prog = _on_card(graphs.StepProgram(body, state, dict(d=torch.ones(3)), limit=4))
    with pytest.raises(RuntimeError, match="warm-up"):
        prog.capture()
    assert calls == [] and prog.graph is None
    prog.run(3)
    # the warm-up steps ran on the state itself, then the capture, then
    # replays for the steps after them
    assert len(calls) == graphs.WARMUP + 1 and set(calls) == {state["x"].data_ptr()}
    assert prog.warmed == graphs.WARMUP and prog.warm_left == 0
    assert prog.graph.replayed == 3 - graphs.WARMUP == prog.replays
    assert prog.launches == {**{k: 0 for k in ops.launch_counts()}, "styled_conv": 9,
                             "pgd_update": 1}
    # the warm-ups launched, the capture did not, each replay adds a step's
    counts = ops.launch_counts()
    assert counts["styled_conv"] == 27 and counts["pgd_update"] == 3
    assert counts["fused_adam"] == 0
    with pytest.raises(ValueError, match="exceed"):
        prog.run(2)
    # a later call replays only
    prog.load(dict(x=torch.zeros(3)), dict(d=torch.ones(3)))
    prog.run(4)
    assert len(calls) == graphs.WARMUP + 1 and prog.graph.replayed == 7 - graphs.WARMUP
    assert ops.launch_counts()["styled_conv"] == 63
    assert captured == [None] and prog.pool == "pool"
    # a program sharing its pool captures into the first one's
    other = _on_card(graphs.StepProgram(body, dict(x=torch.zeros(3)), dict(d=torch.ones(3)),
                                        limit=4, pool_of=prog))
    other.run(graphs.WARMUP + 1)
    assert captured == [None, "pool"]
    prog.release()
    with pytest.raises(RuntimeError, match="released"):
        prog.run(1)
    ops.reset_launch_counts()


def test_a_step_short_of_the_warm_up_captures_nothing(monkeypatch):
    captured = []
    _stub_cuda(monkeypatch, captured)
    calls = []

    def body(state, inputs):
        calls.append(1)
        state["x"].add_(1)

    prog = _on_card(graphs.StepProgram(body, dict(x=torch.zeros(2)), {}, limit=4))
    prog.run(graphs.WARMUP)
    assert prog.graph is None and captured == [] and len(calls) == graphs.WARMUP
    assert prog.state["x"].tolist() == [float(graphs.WARMUP)] * 2
    # on the CPU a program never captures
    cpu = graphs.StepProgram(body, dict(x=torch.zeros(2)), {}, limit=4)
    cpu.run(4)
    assert cpu.graph is None and cpu.replays == 4 and cpu.warm_left == 0
    with pytest.raises(RuntimeError, match="on the card"):
        cpu.capture()


def test_a_body_that_replaces_its_buffers_is_refused(monkeypatch):
    _stub_cuda(monkeypatch, [])

    def body(state, inputs):
        state["x"] = state["x"] + 1

    prog = _on_card(graphs.StepProgram(body, dict(x=torch.zeros(2)), {}, limit=4))
    with pytest.raises(RuntimeError, match="in place"):
        prog.run(graphs.WARMUP + 1)


def test_programs_are_keyed_by_where_their_modules_live():
    net = torch.nn.Linear(2, 2)
    pipe = type("P", (), {})()
    key = graphs.signature(torch.zeros(3), net)
    assert key[1][:2] == ("id", id(net))
    assert graphs.addresses(net) == tuple(p.data_ptr() for p in net.parameters())
    assert graphs.addresses(pipe) == ()
    # a pipeline's nets sit in a plain object inside a dataclass
    pipe.drawer = type("D", (), {})()
    pipe.drawer.generator = net
    assert graphs.addresses(pipe) == graphs.addresses(net) != ()
    built = []
    cache = graphs.ProgramCache(fixed=(net,))
    t = torch.ones(2)
    cache.get(key, lambda: built.append(1) or "a", keep=(t, net))
    cache.get(key, lambda: built.append(1) or "b")
    assert built == [1]
    # the cache keeps the non-tensor arguments only
    assert list(cache.programs.values())[0][1] == (net,)
    # parameters moved (load_state_dict(assign=True), .to()): a new program
    net.load_state_dict({k: v.clone() for k, v in net.state_dict().items()}, assign=True)
    assert graphs.signature(torch.zeros(3), net) != key
    assert cache.get(key, lambda: built.append(1) or "c") == "c" and len(built) == 2
    # a graph bakes in the library kernels its flags chose
    key = graphs.signature(torch.zeros(3), net)
    assert cache.get(key, lambda: "d") == "d"
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not flag
    try:
        assert cache.get(key, lambda: "e") == "e"
    finally:
        torch.backends.cudnn.deterministic = flag
    assert cache.get(key, lambda: "f") == "d"


def test_execution_is_validated_and_decides_the_executor(monkeypatch):
    from tpufusion_torch import runner
    from tpufusion_torch.configs import AttackRunConfig

    with pytest.raises(ValueError, match="execution"):
        wb.WhiteboxConfig(execution="loop")
    assert wb.WhiteboxConfig().execution == jwb.WhiteboxConfig().execution == "scan"
    seen = []

    def fake_run_whitebox(pipeline, inputs, target, cfg, which_adv):
        seen.append((cfg.execution, cfg.grad_accum, cfg.snapshot_every))
        return inputs, {"total": torch.zeros(inputs.shape[0], cfg.n_iters)}

    monkeypatch.setattr(runner, "run_whitebox", fake_run_whitebox)
    gen = type("G", (), {"device": torch.device("cpu")})()
    pipe = type("P", (), {"image_size": 32, "generator": gen})()
    x, t = torch.zeros(2, 32, 32, 3), torch.zeros(1, 32, 32, 3)
    # grad_accum does not decide the executor: both walk the chunks
    for execution, accum, want in (("auto", 1, "scan"), ("stepwise", 1, "stepwise"),
                                   ("scan", 1, "scan"), ("auto", 2, "scan"),
                                   ("scan", 2, "scan"), ("stepwise", 2, "stepwise")):
        cfg = AttackRunConfig(dataset_name="ffhq", n_iters=1, whitebox_execution=execution,
                              whitebox_grad_accum=accum)
        runner.dispatch_attack(pipe, "white_box_target", x, t, cfg, torch.Generator())
        assert seen[-1][:2] == (want, accum), (execution, accum, seen[-1])
    assert runner.resolve_whitebox_execution("auto", True) == "stepwise"


def test_classifier_pgd_program_equals_the_eager_loop():
    model = ResNet(2, width=8, device="cpu", generator=torch.Generator().manual_seed(4))
    model.requires_grad_(False)
    fn = tc.resnet_logits_fn(32)
    x = torch.rand((3, 48, 48, 3), generator=torch.Generator().manual_seed(7)) * 2 - 1
    with torch.no_grad():
        labels = fn(model, x).argmax(-1)

    def ce(adv, net, y):
        return F.cross_entropy(fn(net, adv).float(), y)

    cfg = PGDConfig(eps=EPS, alpha=ALPHA, steps=3)
    start = pgd_random_start(x, torch.Generator().manual_seed(8), cfg)
    got = make_pgd(ce, cfg, external_start=True)(x, start, model, labels)
    _equal_trees(got, pgd_eager(ce, cfg, x, start, model, labels))
