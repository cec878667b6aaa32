"""Example 1: the reference workload on one device.

The reference's flow (sort-merge-join/app.c): load two CSVs, filter,
sort, 1:1 merge-join, write result.csv. Without CSV files it writes the
100k-row reference pair (`generate_table(100_000, seed=1/2)`) into a
temporary directory first.

Run: python -m pim_sort_merge_join_tpu_torch.examples.single_chip_pipeline
         [data1.csv data2.csv] [--output result.csv] [--device cpu]
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile

from pim_sort_merge_join_tpu_torch.examples import example_parser, parse

REFERENCE_ROWS = 100_000


def main(argv=None) -> dict:
    parser = example_parser("single_chip_pipeline", __doc__)
    parser.add_argument("tables", nargs="*", metavar="data.csv",
                        help="the two CSV files (the 100k reference pair if none)")
    parser.add_argument("--output", default="result.csv")
    args = parse(parser, argv)
    if len(args.tables) not in (0, 2):
        parser.error("give two CSV files or none")

    import pim_sort_merge_join_tpu_torch as smj
    from pim_sort_merge_join_tpu_torch.columnar.generate import write_table_pair

    config = smj.EngineConfig(
        predicate1=smj.Predicate(col=0, op=">", value=5000),
        predicate2=smj.Predicate(col=0, op=">", value=5000),
        join_key1=0,
        join_key2=0,
    )
    pipe = smj.QueryPipeline(config, device=args.device)
    with tempfile.TemporaryDirectory(prefix="smj-example-") as d:
        if args.tables:
            d1, d2 = args.tables
        else:
            d1, d2 = os.path.join(d, "data1.csv"), os.path.join(d, "data2.csv")
            write_table_pair(d1, d2, REFERENCE_ROWS, seed=1)
        result = pipe.run_csv(d1, d2, args.output)
    rows = int(result.num_rows)
    print(f"joined rows: {rows}")
    print(pipe.metrics_json())
    with open(args.output, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"rows": rows, "csv_sha256": digest, "stages": [s.name for s in pipe.metrics.stages]}


if __name__ == "__main__":
    main(sys.argv[1:])
