"""Example 3: hash join and hash aggregate.

The comparison path to sort-merge: tables ordered by a bijective hash of
the key instead of the key (`ops/hash_join.py`). Orders (customer id with
duplicates, amount, quantity) join their customers 1:1, and the amounts
are summed per customer.

Run: python -m pim_sort_merge_join_tpu_torch.examples.hash_join_aggregate [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from pim_sort_merge_join_tpu_torch.examples import example_parser, parse


def tables() -> tuple[np.ndarray, np.ndarray]:
    """The orders and customers tables of the JAX example."""
    rng = np.random.default_rng(0)
    orders = np.column_stack(
        [
            rng.integers(1, 50, 2000),      # customer id (duplicates)
            rng.integers(1, 1000, 2000),    # amount
            rng.integers(1, 10, 2000),      # quantity
        ]
    ).astype(np.int64)
    customers = np.column_stack(
        [np.arange(1, 50), rng.integers(1, 5, 49)]
    ).astype(np.int64)
    return orders, customers


def main(argv=None) -> dict:
    args = parse(example_parser("hash_join_aggregate", __doc__), argv)

    from pim_sort_merge_join_tpu_torch.columnar.table import Table
    from pim_sort_merge_join_tpu_torch.ops.hash_join import hash_aggregate, hash_join

    orders, customers = tables()
    t_orders = Table.from_numpy(orders, names=("cust", "amount", "qty"), device=args.device)
    t_cust = Table.from_numpy(customers, names=("cust", "region"), device=args.device)

    joined = hash_join(t_orders, t_cust, 0, 0, mode="one_to_one")
    print(f"joined rows: {int(joined.num_rows)}")

    totals = hash_aggregate(t_orders, key=0, value=1, agg="sum").to_numpy()
    print("per-customer totals (first 5):")
    print(totals[:5])
    return {"joined_rows": int(joined.num_rows), "joined": joined.to_numpy(),
            "totals_first5": totals[:5], "totals": totals}


if __name__ == "__main__":
    main(sys.argv[1:])
