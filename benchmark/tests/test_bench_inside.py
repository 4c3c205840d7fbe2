"""The readers of the program's spans and phase marks
(``benchmark/inside.py`` and the metrics that call it) on synthetic
traces: device activity as (name, start, end), spans as the program's
(name, id, parent, thread, t0, t1), seconds."""
from __future__ import annotations

import types

import pytest

from benchmark import common, inside


def mark(phase, t):
    return (f"vidcap_phase_{phase}", t, t + 0.001)


def step_events(t0, kernels=True):
    """One SCST step from ``t0``: each phase's mark, then 10 ms of kernels
    (two overlapping kernels in the rollout: their union counts once)."""
    ev, t = [], t0
    for phase in ("rollout", "loss", "reward", "loss", "backward",
                  "update"):
        ev.append(mark(phase, t))
        if kernels:
            ev.append((f"{phase}_kernel_a", t + 0.001, t + 0.006))
            ev.append((f"{phase}_kernel_b", t + 0.004, t + 0.011))
        t += 0.02
    ev.append(mark("end", t))
    return ev


def test_phase_time_is_the_union_of_device_busy_time_per_phase():
    ev = step_events(0.0) + step_events(1.0)
    acc, n = inside.phase_seconds(ev)
    assert n == 2
    # each phase: its mark (1 ms) and the kernels' union [1, 11) ms
    per = 0.001 + 0.010
    for phase in ("rollout", "reward", "backward", "update"):
        assert acc[phase] == pytest.approx(2 * per)
    assert acc["loss"] == pytest.approx(2 * 2 * per)   # two loss marks


def test_a_step_cut_by_the_slices_edge_is_left_out():
    whole = step_events(1.0)
    cut_at_start = step_events(0.0)[3:]     # its rollout mark before s0
    cut_at_end = step_events(2.0)[:-1]      # its end mark after s1
    for ev in (whole, cut_at_start + whole, whole + cut_at_end,
               cut_at_start + whole + cut_at_end):
        acc, n = inside.phase_seconds(ev)
        assert n == 1
        assert acc["rollout"] == pytest.approx(0.011)
        assert acc["loss"] == pytest.approx(0.022)
    assert inside.phase_seconds(cut_at_start + cut_at_end)[1] == 0


def test_microbatches_repeat_their_marks_inside_one_step():
    ev, t = [], 0.0
    for phase in ("rollout", "loss", "reward", "loss", "backward") * 2 + (
            "update", "end"):
        ev.append(mark(phase, t))
        t += 0.01
    acc, n = inside.phase_seconds(ev)
    assert n == 1
    assert acc["rollout"] == pytest.approx(0.002)
    assert acc["loss"] == pytest.approx(0.004)


def test_host_to_device_copies_do_not_count():
    ev = step_events(0.0, kernels=False)
    # the loader's staging copy on its own stream, inside the rollout phase
    ev.append(("Memcpy HtoD (Pinned -> Device)", 0.002, 0.015))
    # a device-to-device copy inside the update phase does count
    ev.append(("Memcpy DtoD (Device -> Device)", 0.102, 0.104))
    acc, n = inside.phase_seconds(ev)
    assert n == 1
    assert acc["rollout"] == pytest.approx(0.001)
    assert acc["update"] == pytest.approx(0.003)
    # and between steps (after the end mark) nothing counts
    ev.append(("between_steps_kernel", 0.125, 0.2))
    assert inside.phase_seconds(ev)[0]["update"] == pytest.approx(0.003)


def test_marks_match_no_other_metrics_kernels():
    """The marks' names stay out of the regexes of the kernels' metrics,
    and those kernels' names out of the marks'."""
    import re
    for name in ("elementwise_share.scst", "k1_roofline.bulk",
                 "k2_roofline.bulk", "k3_roofline.scst"):
        rx = common.load_module(common.metric_file(name)).KERNELS
        for phase in ("rollout", "reward", "loss", "backward", "update",
                      "end"):
            assert not re.search(rx, f"vidcap_phase_{phase}")
    assert not inside.MARK.search(
        "_anonymous_namespace_::rollout_kernel(Params)")
    assert not inside.MARK.search("spin_kernel")


def span(name, t0, t1, id=None):
    return (name, id, None, 1, t0, t1)


def test_the_hosts_lead_matches_steps_and_replays_in_order():
    # the host launched step j at 0.5 j; the card starts it 0.2 later, but
    # the first one 0.001 after the launch
    starts = [0.001, 0.7, 1.2, 1.7]
    ev = [e for s in starts for e in step_events(s, kernels=False)]
    # the spans out of order in the store (threads), one each a step
    spans = [span("dispatch.replay", 0.5 * j - 0.0005, 0.5 * j, j)
             for j in (2, 0, 3, 1)]
    spans += [span("dispatch.inputs", 0.5 * j - 0.002, 0.5 * j - 0.001)
              for j in range(4)]
    lead = inside.host_lead_ms(ev, spans)
    # leads 1, 200, 200, 200 ms: the median 200
    assert lead == pytest.approx(200.0)
    assert inside.host_lead_ms(ev, []) is None
    assert inside.host_lead_ms([], spans) is None


def test_the_idle_after_each_exit_check():
    """Each read pairs with its device-to-host copy by order (the host's
    clock and the device's never compared); the idle runs from the copy's
    end to the next activity, none where other work runs past it."""
    copy = "Memcpy DtoH (Device -> Pageable)"
    events = [("k", 0.0, 1.0), (copy, 1.0, 1.01),        # idle to 1.5
              ("k", 1.5, 2.0), ("k", 1.9, 3.0), (copy, 2.5, 2.6),
              (copy, 3.0, 3.05),                         # idle to 4.0
              ("k", 4.0, 5.0), (copy, 5.0, 5.1)]         # a download
    # the host's spans end after their copies, here by much more than the
    # device's gaps: only their order counts
    spans = [span("beam.exit_check", 0.5, 1.3, 0),
             span("beam.exit_check", 2.0, 3.3, 1),        # busy past 2.6
             span("beam.exit_check", 3.2, 3.4, 2),
             span("captioner.download", 5.0, 5.5, 0),
             span("beam.step", 1.0, 1.2)]                # not a read
    got = inside.sync_idle(spans, events, 0.0, 6.0)
    assert got == pytest.approx((0.49 + 0.95) / 6.0 * 100)
    # a read without its copy in the slice: the pairing is off, no reading
    assert inside.sync_idle(spans, events[:-1], 0.0, 6.0) is None
    assert inside.sync_idle(spans[-2:], events[-1:], 0.0, 6.0) is None


def test_idle_after_a_time_counts_to_the_next_activity():
    busy = inside.merge([(0.0, 1.0), (1.5, 2.0), (1.9, 3.0), (4.0, 5.0)])
    assert busy == [(0.0, 1.0), (1.5, 3.0), (4.0, 5.0)]
    # 1.0 ends an interval: idle to 1.5; 2.5 lies inside one: none; 5.5 to
    # the slice's end
    assert inside.idle_after([1.0, 2.5, 5.5], busy, 6.0) == \
        pytest.approx(0.5 + 0.5)


def test_upload_ms_is_a_decodes_mean():
    spans = [span("captioner.decode", 0.0, 1.0, 0),
             span("captioner.upload", 0.0, 0.04, 0),
             span("captioner.decode", 1.0, 2.0, 1),
             span("captioner.upload", 1.0, 1.05, 1),
             span("captioner.download", 1.9, 2.0, 1)]
    assert inside.upload_ms(spans) == pytest.approx(45.0)
    assert inside.upload_ms(spans[1:2]) is None


def _run(events, s0=0.0, s1=10.0):
    tracer = types.SimpleNamespace(s0=s0, s1=s1, in_slice=lambda: events,
                                   busy_intervals=lambda: inside.merge(
                                       (a, b) for _, a, b in events))
    return types.SimpleNamespace(tracer=tracer, data={})


@pytest.mark.parametrize("m", [m["name"] for m in common.manifest()[
    "per_layer"] if m["name"] in (
        "upload_ms.bulk", "sync_idle.bulk", "rollout_ms.scst",
        "reward_ms.scst", "loss_ms.scst", "backward_ms.scst",
        "update_ms.scst", "host_lead_ms.scst")])
def test_each_reader_is_silent_with_nothing_to_read(m, monkeypatch):
    """Outside a traced run, on a trace without marks or spans, and with a
    program that keeps no span store (the parent of these readers), each
    new reader returns None and does not raise."""
    from vidcap_tpu_torch.utils import profiling
    read = common.load_module(common.metric_file(m)).read
    assert read(types.SimpleNamespace(tracer=None, data={})) is None
    profiling.clear()
    assert read(_run([("some_kernel", 1.0, 2.0)])) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(_run([("some_kernel", 1.0, 2.0)])) is None


def test_the_phase_readers_on_a_trace():
    ev = step_events(1.0) + step_events(2.0)
    r = _run(ev)
    got = {m: common.load_module(common.metric_file(m)).read(r)
           for m in ("rollout_ms.scst", "reward_ms.scst", "loss_ms.scst",
                     "backward_ms.scst", "update_ms.scst")}
    assert got["loss_ms.scst"] == pytest.approx(22.0)
    for m in ("rollout_ms.scst", "reward_ms.scst", "backward_ms.scst",
              "update_ms.scst"):
        assert got[m] == pytest.approx(11.0)


def test_the_span_readers_take_the_programs_store_inside_the_slice():
    from vidcap_tpu_torch.utils import profiling
    profiling.clear()
    try:
        with profiling.recording():
            for name in ("captioner.decode", "captioner.upload"):
                with profiling.annotate(name, 0):
                    pass
        decode, upload = profiling.spans()
        r = _run([("k", 0.0, 1.0)], s0=decode.t0 - 1, s1=upload.t1 + 1)
        got = common.load_module(common.metric_file("upload_ms.bulk")).read(r)
        assert got == pytest.approx((upload.t1 - upload.t0) * 1e3)
        # a slice that ends before the spans sees none of them
        r.tracer.s1 = decode.t0 - 0.5
        assert inside.program_spans(r) == []
    finally:
        profiling.clear()
