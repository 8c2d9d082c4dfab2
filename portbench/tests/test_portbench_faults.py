"""Runs with the timed path broken underneath come out not correct: the
rest of a run as the harness drives it (the look for a card skipped), at
a tiny size on the CPU, with the cell's own limits, once for each fault
the cell can have. A run of one chip has no exchange between chips to
leave out."""

import pytest

from portbench.tests.cells import MAN, run_tiny

TRAIN = [w["name"] for w in MAN["workloads"] if w["traffic"].startswith(
    "train")]


def _frozen(monkeypatch):
    """Each step returns its state unchanged (the counter aside)."""
    import clstm_tpu_torch.train as tr

    def apply_update(state, grads, clip, lr, momentum):
        state.step += 1
    monkeypatch.setattr(tr, "apply_update", apply_update)


def _half(monkeypatch):
    """Each step takes half of its batch's rows, the mean over the rest."""
    import clstm_tpu_torch.train as tr
    gather = tr.gather_batch

    def gather_batch(group, idx, input_onehot=0):
        return gather(group, idx[:max(len(idx) // 2, 1)], input_onehot)
    monkeypatch.setattr(tr, "gather_batch", gather_batch)


def _reused(monkeypatch):
    """Every step of a block call trains on the block's first batch."""
    from clstm_tpu_torch.models.hl import CLSTMOCR
    call = CLSTMOCR.train_batch_block

    def train_batch_block(self, block, k_max=0, nvalid=None):
        j, idx = block["j"], block["idx_all"].clone()
        idx[j:j + block["k"]] = idx[j]
        return call(self, dict(block, idx_all=idx), k_max, nvalid)
    monkeypatch.setattr(CLSTMOCR, "train_batch_block", train_batch_block)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_frozen, _half, _reused],
                         ids=["frozen", "half", "reused"])
def test_a_broken_training_step_is_not_correct(workload, fault,
                                               monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(workload)["correct"]

