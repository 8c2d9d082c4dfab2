"""The plain reference against the program's plain path on the CPU, at a
tiny size in f32: the first steps' losses, first gradient and change, and
the net's posteriors, agree to f32 rounding, and each cell's run comes out
correct."""

import json

import pytest

from portbench import registry
from portbench.tests.cells import MAN, run_tiny

F32 = 1e-5


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_a_cell_at_a_tiny_size_agrees_with_the_reference(workload):
    res = run_tiny(workload)
    json.dumps(res)                     # the result line is plain JSON
    assert res["correct"], res["checks"]
    ch = {k: c["value"] for k, c in res["checks"].items()}
    assert max(ch["loss_gap"], ch["grad_gap"], ch["change_gap"]) < F32
    assert res["notes"]["nonfinite"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"


def test_the_reference_net_is_the_programs_forward():
    """The reference's posteriors against the program's plain forward on
    the same weights and frames."""
    import torch
    from clstm_tpu_torch.models.spec import apply_net
    from portbench import corpus, program
    from portbench.reference import net
    cfg = dict(registry.config(MAN, "bidi2"), nhidden_layers=[5, 7],
               noutput=9, precision="f32")
    w = net.make_weights(cfg, corpus.generator(3, 3, "cpu"),
                         {"Wx": 0.3, "Wh": 0.05, "b": 0.3, "softmax": 1.0},
                         "cpu")
    ocr = program.model(cfg, w, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((4, 23, cfg["ninput"]), generator=g)
    L = torch.tensor([23, 1, 17, 9], dtype=torch.int32)
    want = torch.log_softmax(apply_net(ocr.net, x, L, logits=True,
                                       xz_bf16=False), -1)
    got = torch.log_softmax(net.logits(w, x, L), -1)
    mask = torch.arange(23)[None, :] < L[:, None]
    assert torch.allclose(got[mask], want[mask], atol=1e-5)
