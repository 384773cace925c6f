"""The plain reference on cases whose answer is known, and the judge."""
from __future__ import annotations

import torch

from portbench import reference
from portbench.judge import Judge


def line(n=20):
    """Vectors on a line at 0, 1, 2, ... in the first coordinate."""
    x = torch.zeros(n, 3)
    x[:, 0] = torch.arange(n, dtype=torch.float32)
    return x


def test_exact_topk_on_a_line():
    x = line()
    q = torch.tensor([[4.2, 0.0, 0.0], [18.9, 0.0, 0.0]])
    ids = reference.exact_topk(x, q, 3)
    assert ids.tolist() == [[4, 5, 3], [19, 18, 17]]


def test_exact_distances_sum_in_float64_and_mark_bad_ids():
    x = line()
    q = torch.tensor([[4.5, 1.0, 0.0]])
    d = reference.exact_distances(x, q, torch.tensor([[4, 7, -1, 20]]))
    assert d[0, 0].item() == 0.25 + 1.0 and d[0, 1].item() == 6.25 + 1.0
    assert torch.isnan(d[0, 2:]).all()


def test_round_tf32_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, 1.0 + 2**-11 + 2**-13])
    assert reference.round_tf32(v).tolist() == [1.0 + 2**-10, 1.0,
                                                1.0 + 2**-10]


def test_the_control_answers_with_tf32_distances():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(300, 64, generator=g)
    q = x[:50] + 0.1 * torch.randn(50, 64, generator=g)
    ids, dists = reference.control_topk(x, q, 10)
    exact = reference.exact_distances(x, q, ids)
    gap = ((dists.double() - exact).abs() / exact).max().item()
    assert gap > 1e-3


def test_the_judge_holds_each_answer_to_the_guarantees():
    x = line()
    q = torch.tensor([[4.2, 0.0, 0.0], [10.0, 0.5, 0.0]])
    truth = reference.exact_topk(x, q, 3)
    exact = reference.exact_distances(x, q, truth).float().numpy()
    limits = {"dist_gap": 1e-4, "recall_at_10": 0.9}

    j = Judge(x, 3, limits)
    j.add(q, truth.numpy(), exact)
    assert j.correct() and j.failed == 0 and j.recall == 1.0

    wrong = truth.numpy().copy()
    wrong[1, 2] = 0                      # an id whose distance differs
    j = Judge(x, 3, limits)
    j.add(q, wrong, exact)
    assert not j.correct() and j.failed == 1 and j.dist_gap > 0.5

    dup = truth.numpy().copy()
    dup[0, 2] = dup[0, 1]
    j = Judge(x, 3, limits)
    j.add(q, dup, exact)
    assert j.bad_ids == 1 and not j.correct()

    pad = truth.numpy().copy()
    pad[0, 2] = -1                       # padding with a finite distance
    j = Judge(x, 3, limits)
    j.add(q, pad, exact)
    assert j.bad_ids == 1

    j = Judge(x, 3, limits)
    j.add(q, truth.numpy()[:1], exact[:1])
    assert j.unanswered == 1 and j.failed == 1 and j.recall == 0.5
