"""The generator: the same seed gives the same traffic, another seed the
same work at the same times with other token ids."""

import numpy as np
import pytest

from benchmark.traffic import make_requests

OPEN = {"driver": "open", "block": 16,
        "arrivals": {"dist": "poisson", "rate": 8.0},
        "prompt_len": {"dist": "log_uniform", "lo": 32, "hi": 768},
        "output_len": {"dist": "uniform", "lo": 64, "hi": 256}}
CLOSED = {"driver": "closed", "block": 16, "requests": 64,
          "prompt_len": {"dist": "log_uniform", "lo": 512, "hi": 6144},
          "output_len": {"dist": "fixed", "value": 32}}


def flat(reqs):
    return [(r.prompt.tolist(), r.max_new, r.due) for r in reqs]


@pytest.mark.parametrize("wl", [OPEN, CLOSED], ids=["open", "closed"])
def test_same_seed_same_traffic(wl):
    big = 2 ** 31 + 12345
    assert flat(make_requests(wl, big, 6.0, 1000)) == \
        flat(make_requests(wl, big, 6.0, 1000))


@pytest.mark.parametrize("wl", [OPEN, CLOSED], ids=["open", "closed"])
def test_other_seed_same_work_other_tokens(wl):
    a = make_requests(wl, 1, 6.0, 1000)
    b = make_requests(wl, 2, 6.0, 1000)
    assert len(a) == len(b)
    assert [(len(r.prompt), r.max_new, r.due) for r in a] == \
        [(len(r.prompt), r.max_new, r.due) for r in b]
    assert all(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    # each block holds every quantile level once, in an order of its own
    for blk in range(len(a) // 16):
        sizes = [len(r.prompt) for r in a[16 * blk:16 * (blk + 1)]]
        assert sorted(sizes) == sorted(len(r.prompt) for r in a[:16])
    if len(a) >= 32:
        assert [len(r.prompt) for r in a[:16]] != \
            [len(r.prompt) for r in a[16:32]]
    if wl["driver"] == "open":
        # every block of arrivals lasts 16 / rate seconds
        assert a[-16].due == pytest.approx((len(a) // 16 - 1) * 16 / 8.0)


def test_sizes_follow_the_distributions():
    reqs = make_requests(OPEN, 3, 8.0, 50257)
    lengths = np.array([len(r.prompt) for r in reqs])
    outs = np.array([r.max_new for r in reqs])
    assert lengths.min() >= 32 and lengths.max() <= 768
    assert outs.min() >= 64 and outs.max() <= 256
    # log-uniform: the median length near the geometric mean of the ends
    assert 120 < np.median(lengths) < 200
    assert len(reqs) == 64  # ceil(8 / s x 8 s / 16) blocks of 16
    assert all(0 <= r.prompt.min() and r.prompt.max() < 50257 for r in reqs)


def test_poisson_block_lasts_block_over_rate():
    reqs = make_requests(OPEN, 4, 4.0, 100)
    assert len(reqs) == 32
    gaps = np.diff([r.due for r in reqs[:17]])
    assert gaps.sum() == pytest.approx(16 / 8.0)


def test_outputs_cut_to_max_total():
    wl = dict(CLOSED, prompt_len={"dist": "log_uniform", "lo": 16,
                                  "hi": 600},
              output_len={"dist": "log_uniform", "lo": 64, "hi": 1000},
              max_total=1024)
    reqs = make_requests(wl, 6, 1.0, 100)
    totals = [len(r.prompt) + r.max_new for r in reqs]
    assert max(totals) == 1024
    assert max(r.max_new for r in reqs) < 1000
    uncut = make_requests(dict(wl, max_total=0), 6, 1.0, 100)
    assert [r.max_new for r in reqs] == [min(u.max_new, 1024 - len(u.prompt))
                                         for u in uncut]
