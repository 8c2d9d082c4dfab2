"""The benchmark's frozen arithmetic, pinned to values worked out by hand
(bytes at 3.35 TB/s, flop at 989 TFLOP/s in bf16)."""

import pytest

from portbench import bounds, registry

MAN = registry.manifest()
HBM = 3.35e12


@pytest.mark.parametrize("name, train, flop", [
    ("bidi", True, 830_976), ("bidi2", True, 9_122_400),
    ("bidi", False, 276_992), ("bidi2", False, 3_040_800)])
def test_flop_per_valid_frame(name, train, flop):
    # 3 x 2 x [sum over layers of 2*4H(D+1+H) + C(2H+1)]; the forward alone
    # takes 2 x the bracket: bidi 2*400*149 + 96*201 = 138,496.
    assert bounds.flop_per_frame(registry.config(MAN, name), train) == flop


# The bench shape (B=256, T=1024, every line 900 frames) in bf16: the
# bytes of each work, counted by hand from its streams.
B, T, V = 256, 1024, 256 * 900


@pytest.mark.parametrize("kind, D, H, dx, nbytes", [
    # x at V frames, [Wx;b;Wh] both directions, y at B*T, lengths, and the
    # f32 gates and bf16 cell at B*T: 2*(11,059,200 + 119,200 + 52,428,800)
    # + 1,024 + 3,600*262,144.
    ("fwd_state", 48, 100, False, 1_070_933_824),
    # gates and cell at V, y and Wh and dz at B*T: 3,600*230,400
    # + 2*(46,080,000 + 80,000 + 209,715,200) + 1,024.
    ("chain", 48, 100, False, 1_341_191_424),
    # x, y, dz at V, dW f32: 2*230,400*1,048 + 8*149*400.
    ("reduce", 48, 100, False, 483_395_200),
])
def test_lstm_bound_bytes(kind, D, H, dx, nbytes):
    ms, by = bounds.lstm_bound(kind, B, T, D, H, V, dx=dx, esize=2)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / HBM * 1e3, rel=1e-12)


def test_lstm_bound_ops():
    # K3 at bidi2's first layer: 2*V*2*249*800 flop at 989 TFLOP/s.
    ms, by = bounds.lstm_bound("fwd", B, T, 48, 200, V, esize=2)
    assert by == "operations"
    assert ms == pytest.approx(2 * V * 2 * 249 * 800 / 989e12 * 1e3)


@pytest.mark.parametrize("kind, nbytes", [
    ("forward", 2 * 4 * 256 * 1024 * 81 + 4 * 256),
    ("both", 3 * 4 * 256 * 1024 * 81 + 4 * 256 * 81 + 8 * 256)])
def test_ctc_bound(kind, nbytes):
    ms, by = bounds.ctc_bound(kind, 256, 1024, 81)
    assert by == "bytes" and ms == pytest.approx(nbytes / HBM * 1e3)


def test_step_bound_sums_the_layers_work():
    cfg = registry.config(MAN, "bidi2")
    e = 2
    want = (bounds.lstm_bound("fwd_state", B, T, 48, 200, V, esize=e)[0]
            + bounds.lstm_bound("chain", B, T, 48, 200, V, esize=e)[0]
            + bounds.lstm_bound("reduce", B, T, 48, 200, V, esize=e)[0]
            + bounds.lstm_bound("xz_state", B, T, 400, 200, V, esize=e)[0]
            + bounds.lstm_bound("chain", B, T, 400, 200, V, esize=e)[0]
            + bounds.lstm_bound("reduce", B, T, 400, 200, V, dx=True,
                                esize=e)[0])
    assert bounds.lstm_step_bound_ms(cfg, B, T, V, True) == pytest.approx(
        want)
    serve = (bounds.lstm_bound("fwd", B, T, 48, 200, V, esize=e)[0]
             + bounds.lstm_bound("xz", B, T, 400, 200, V, esize=e)[0])
    assert bounds.lstm_step_bound_ms(cfg, B, T, V, False) == pytest.approx(
        serve)


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_the_priced_layer_plan_is_the_programs(name):
    from clstm_tpu_torch.ops.bidi_lstm_kernel import hoists_projection
    for D, H in bounds.layers(registry.config(MAN, name)):
        assert bounds.hoists(D, H) == hoists_projection(D, H)


def test_peaks_of_the_h100():
    pk = bounds.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flops"] == 989e12 and pk["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        bounds.peaks("some other card")
