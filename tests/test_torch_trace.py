"""The port's tracer (``tpufusion_torch/core/trace.py``) on the CPU: off
without a profiler session, the program's host spans nested by time under
one, the kernels' launch counts in its counter table, and a traced
dispatch's answer equal to an untraced one's. The device spans inside a
replay run only on the card (``tests/test_torch_cuda.py``)."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_graphs import _on_card, _stub_cuda
from tests.torch_pipelines import one_torch_thread  # noqa: F401
from tpufusion_torch import ops, runner
from tpufusion_torch.configs import AttackRunConfig
from tpufusion_torch.core import graphs, trace
from tpufusion_torch.ops import adam_update as au
from tpufusion_torch.ops import conv3x3 as c3
from tpufusion_torch.ops import pgd_update as pu

N = 3  # the church roles


@pytest.fixture(scope="module")
def tiny():
    """The port's own church 32^2 test pipeline, with inputs and a target
    (``tests/test_torch_dispatch.py``'s ``tiny``)."""
    from tpufusion_torch.pipeline import create_test_pipeline

    p = create_test_pipeline("church", device="cpu", seed=2)
    g = torch.Generator().manual_seed(3)
    return (p, torch.rand(N, 32, 32, 3, generator=g) * 2 - 1,
            torch.rand(1, 32, 32, 3, generator=g) * 2 - 1)


def _whitebox(tiny, steps=2):
    p, inputs, target = tiny
    cfg = AttackRunConfig(dataset_name="church", n_iters=steps, snapshot_every=0)
    (adv,) = runner.dispatch_attack(p, "white_box_target", inputs, target, cfg,
                                    torch.Generator().manual_seed(7))
    return adv


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def test_off_without_a_profiler_session(tiny, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    programs = len(trace.PROGRAMS)
    assert trace.span("a") is trace.device_span("b") is trace._OFF
    assert trace.begin("c") is None
    trace.end(None)
    with trace.capture() as record:
        assert record is None and trace.device_span("d") is trace._OFF
    _whitebox(tiny)
    assert len(trace.PROGRAMS) == programs and trace._capturing is None


def test_a_traced_dispatch_nests_its_spans(tiny, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # outside a capture a device span does nothing, tracing or not
        assert trace.device_span("step") is trace._OFF
        handle = trace.begin("across.calls")
        trace.end(handle)
        _whitebox(tiny, steps=2)
    spans = _annotations(prof, tmp_path)
    assert [n for *_, n in spans if n == "across.calls"] == ["across.calls"]
    (d0, d1, _), = [s for s in spans if s[2] == "runner.dispatch"]
    inside = [(s, e, n) for s, e, n in spans if d0 <= s and e <= d1 and n != "runner.dispatch"]
    # on the CPU no warm-up and no capture: the body runs at each step
    assert [n for *_, n in inside] == ["attack.prepare", "program.replay", "program.replay"]
    ends = [e for _, e, _ in inside]
    starts = [s for s, _, _ in inside]
    assert all(ends[i] <= starts[i + 1] for i in range(len(inside) - 1))


def test_warm_up_span_closes_at_the_next_capture(monkeypatch, tmp_path):
    """Chunk programs that warm up in turn share one ``program.warmup``
    span, closed by the first capture's synchronize, so no two program
    spans overlap; a program released before its capture closes it too."""
    _stub_cuda(monkeypatch, [])

    def body(state, inputs):
        state["x"].add_(1)

    def program():
        return _on_card(graphs.StepProgram(body, dict(x=torch.zeros(2)), {}, limit=4))

    chunks, lone = [program(), program()], program()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):  # two steps, chunk after chunk, as the runners take them
            for prog in chunks:
                prog.run(1)
        lone.run(graphs.WARMUP)
        lone.release()
    spans = _annotations(prof, tmp_path)
    assert [n for *_, n in spans] == ["program.warmup", "program.capture", "program.replay",
                                      "program.capture", "program.replay", "program.warmup"]
    assert all(spans[i][1] <= spans[i + 1][0] for i in range(len(spans) - 1))
    assert graphs._warming is None


def test_launch_counts_live_in_the_counter_table(monkeypatch):
    """The wrappers' CUDA branches, reached with meta tensors and the
    launches stubbed, count in ``trace.LAUNCHES``; ``ops`` reads, resets and
    adds to it as it read the wrappers' own counts."""
    keys = ["styled_conv", "styled_conv_up", "conv3x3_fwd", "conv3x3_dgrad", "conv3x3_wgrad",
            "pgd_update", "fused_adam", "styled_conv_bwd", "styled_conv_up_bwd",
            "styled_conv_bwd_composite"]
    saved = ops.launch_counts()
    assert list(saved) == keys and list(trace.LAUNCHES) == keys
    try:
        ops.reset_launch_counts()
        assert ops.launch_counts() == dict.fromkeys(keys, 0)
        monkeypatch.setattr(pu, "pgd_update_kernel", lambda adv, *a: adv.clone())
        monkeypatch.setattr(au, "adam_update_kernel", lambda *a: None)
        monkeypatch.setattr(c3, "conv3x3_forward_kernel", lambda x, w: torch.empty_like(x))
        monkeypatch.setattr(c3, "conv3x3_input_grad_kernel", lambda g, w: torch.empty_like(g))
        monkeypatch.setattr(c3, "conv3x3_weight_grad_kernel",
                            lambda x, g: x.new_empty((3, 3, x.shape[-1], x.shape[-1])))
        x = torch.empty((1, 4, 4, 3), device="meta")
        pu.pgd_update(x, x, x, 0.1, 0.2)
        st = dict(mu=torch.empty_like(x), nu=torch.empty_like(x),
                  count=torch.zeros((), dtype=torch.int32, device="meta"))
        au.fused_adam(x, x, st, 1e-2)
        xc = torch.empty((1, 4, 4, 32), device="meta", requires_grad=True)
        wc = torch.empty((3, 3, 32, 32), device="meta", requires_grad=True)
        torch.autograd.grad(c3.conv3x3(xc, wc).sum(), (xc, wc))
        assert ops.launch_counts() == dict(styled_conv=0, styled_conv_up=0, conv3x3_fwd=1,
                                           conv3x3_dgrad=1, conv3x3_wgrad=1, pgd_update=1,
                                           fused_adam=1, styled_conv_bwd=0, styled_conv_up_bwd=0,
                                           styled_conv_bwd_composite=0)
        ops.add_launch_counts(dict(styled_conv=9, fused_adam=2))
        ops.add_launch_counts(dict(fused_adam=-1))
        got = ops.launch_counts()
        assert got["styled_conv"] == 9 and got["fused_adam"] == 2 and got is not trace.LAUNCHES
    finally:
        ops.reset_launch_counts()
        ops.add_launch_counts(saved)


def test_a_traced_dispatch_answers_as_an_untraced_one(tiny):
    plain = _whitebox(tiny, steps=3)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _whitebox(tiny, steps=3)
    assert torch.equal(plain, traced) and not torch.equal(plain, tiny[1])
