"""The JAX package's five examples on the port, one module each:

    python -m pim_sort_merge_join_tpu_torch.examples.<name> [--device cpu] [--simulator N]

``single_chip_pipeline``, ``distributed``, ``hash_join_aggregate``,
``streaming_merge_checkpoint`` and ``skew_and_profiling``. Each runs on the
card unless ``--device`` names another device; ``--simulator N`` without
``--device`` runs on the CPU (N Gloo ranks for the multi-device examples,
which take 4 ranks otherwise). Each module's ``main(argv)`` prints what the
JAX example prints and returns it as a dict.
"""

from __future__ import annotations

import argparse

NAMES = ("single_chip_pipeline", "distributed", "hash_join_aggregate",
         "streaming_merge_checkpoint", "skew_and_profiling")
DEFAULT_RANKS = 4


def example_parser(name: str, doc: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=f"python -m pim_sort_merge_join_tpu_torch.examples.{name}",
        description=doc.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card unless named ('cpu' runs the kernels' plain versions)")
    parser.add_argument("--simulator", type=int, metavar="N", default=None,
                        help="run on the CPU (N Gloo ranks for the multi-device examples)")
    return parser


def parse(parser: argparse.ArgumentParser, argv) -> argparse.Namespace:
    """The parsed arguments; ``device`` is "cpu" under ``--simulator``
    unless named, ``ranks`` the multi-device examples' rank count."""
    args = parser.parse_args(argv)
    if args.device is None and args.simulator:
        args.device = "cpu"
    args.ranks = args.simulator or DEFAULT_RANKS
    return args
