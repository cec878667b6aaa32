"""The per-layer readers on a traced window made by hand: two queries,
their kernels, a copy, and the gaps between them (microseconds)."""

import pytest

from benchmark import harness, traced

SORT = "void (anonymous namespace)::merge_kernel<false, false>(unsigned long const*)"
GATHER = "(anonymous namespace)::gather_rows_kernel((anonymous namespace)::RowsArgs, int)"
SCAN = "void (anonymous namespace)::join_scan_forward_kernel<int>(int const*)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long> >(int)"
COPY = "Memcpy DtoH (Device -> Pageable)"


@pytest.fixture
def tw():
    device_ops = [
        (SORT, 10, 40), (GATHER, 40, 50), (TORCH, 60, 70), (COPY, 75, 80),  # query 1: 10-90
        (SORT, 110, 150), (SCAN, 150, 155), (TORCH, 155, 160),  # query 2: 100-170
        (TORCH, 175, 180),  # between queries: not the query's
    ]
    spans = {"query": [(10, 90), (100, 170)], "h2d": [(0, 10)], "d2h": [(170, 190)]}
    host_ops = [("aten::min", 50, 60), ("aten::item", 80, 90)]
    return traced.TracedWindow(device_ops, spans, host_ops, queries=2, least_bytes=3.35e6,
                               peak_bytes_per_s=3.35e12)


def read(name, tw):
    return harness.load_module("layers", name).read(tw)


def test_kernel_time_by_layer(tw):
    assert read("sort_ms_per_query", tw) == pytest.approx((30 + 40) / 2 / 1e3)
    assert read("gather_ms_per_query", tw) == pytest.approx(10 / 2 / 1e3)
    assert read("scan_ms_per_query", tw) == pytest.approx(5 / 2 / 1e3)
    assert read("torch_ops_ms_per_query", tw) == pytest.approx((10 + 5) / 2 / 1e3)


def test_spans_gaps_and_shares(tw):
    busy_in_queries = 30 + 10 + 10 + 5 + 40 + 5 + 5
    assert read("host_gap_ms_per_query", tw) == pytest.approx((150 - busy_in_queries) / 2 / 1e3)
    assert read("device_idle_share", tw) == pytest.approx(100 * (1 - 110 / 190))
    # 3.35e6 bytes at 3.35e12 bytes/s is 1 us, over 105 us busy inside the queries.
    assert read("query_roofline_share", tw) == pytest.approx(100 / busy_in_queries)


def test_readers_find_nothing_without_the_card(tw):
    tw.device_ops = []
    for name in ("sort_ms_per_query", "device_idle_share", "query_roofline_share",
                 "host_gap_ms_per_query"):
        assert read(name, tw) is None


def test_breakdown_names_idle_time_by_what_the_host_did(tw):
    b = traced.breakdown(tw)
    assert b["device_ops"][0] == [SORT, 70 / 1e6]
    idle = dict(b["idle_gaps"])
    assert idle["query / aten::min"] == pytest.approx(10 / 1e6)
    assert idle["query / aten::item"] == pytest.approx(10 / 1e6)
    assert idle["h2d"] == pytest.approx(10 / 1e6)
    assert sum(idle.values()) == pytest.approx((190 - 110) / 1e6)
