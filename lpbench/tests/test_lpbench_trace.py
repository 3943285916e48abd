"""The reduction of a device trace, on a timeline made by hand."""
import pytest

from lpbench.trace import reduce_events

K = "void at::native::vectorized_elementwise_kernel<4, at::native::{}_kernel_cuda(at::TensorIteratorBase&)>"


def timeline():
    """Prime burst to 100; an evaluation [sin 110-111, K1 111-131, K2
    135-145, cos 145-146]; the rule 150-160; a read to the host 160-162;
    idle to 200; a second evaluation [sin 200-201, K1 201-221, cos
    221-222]; the drain burst from 300."""
    ns = 1_000_000
    ev = [(90 * ns, 100 * ns, K.format("atan")),
          (110 * ns, 111 * ns, K.format("sin")),
          (111 * ns, 131 * ns, "dual_x_kernel"),
          (135 * ns, 145 * ns, "ax_items_kernel"),
          (145 * ns, 146 * ns, K.format("cos")),
          (150 * ns, 160 * ns, "rule_kernel"),
          (160 * ns, 162 * ns, "Memcpy DtoH (Device -> Pinned)"),
          (200 * ns, 201 * ns, K.format("sin")),
          (201 * ns, 221 * ns, "dual_x_kernel"),
          (221 * ns, 222 * ns, K.format("cos")),
          (300 * ns, 301 * ns, K.format("sinh"))]
    return ev[::-1]          # the reduction sorts


def test_window_busy_and_evaluations():
    tr = reduce_events(timeline())
    assert tr["window_s"] == pytest.approx(0.2)
    # 1 + 20 + 10 + 1 + 10 + 2 + 1 + 20 + 1 ms busy
    assert tr["busy_s"] == pytest.approx(0.066)
    assert tr["calculate_s"] == pytest.approx([0.030, 0.020])
    assert tr["device_ops"][0] == ["dual_x_kernel", pytest.approx(0.040)]
    gaps = dict((w, d) for w, d in tr["idle_gaps"])
    assert gaps["after a read to the host (the engine's check)"] == \
        pytest.approx(0.038)
    assert gaps["inside calculate"] == pytest.approx(0.004)
    assert gaps["the solve's start (the engine's set-up)"] == \
        pytest.approx(0.010)
    assert gaps["between evaluations (the rule's step, the engine)"] == \
        pytest.approx(0.004)
    assert tr["idle_gaps"][0] == ["the solve's end (the engine's return)",
                                  pytest.approx(0.078)]
    assert sum(d for _, d in tr["idle_gaps"]) == pytest.approx(
        tr["window_s"] - tr["busy_s"])


def test_no_brackets_reads_nothing():
    tr = reduce_events([e for e in timeline() if "sinh" not in e[2]])
    assert "busy_s" not in tr and "calculate_s" not in tr
