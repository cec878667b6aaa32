"""Traffic mode ``sharded``: the configuration's table pair resident on
``cell.chips`` cards, one rank each (`benchmark/ranks.py`). Every rank
makes the whole pair from the seed on its card, keeps its row block
(`program.row_block`, the scatter of `ShardedTable.from_numpy`) and frees
the rest before the peak is reset. Every query runs
`DistributedQueryPipeline.run_tables` on the blocks; its result is usable
when the call returns, which has gathered every rank's row count. The
ranks' outputs in rank order are the query's rows (with
``partition_scheme="range"``, byte for byte the one-card output), and the
check compares them in that order."""

from __future__ import annotations

import numpy as np


def pair_of(traffic: dict, i: int) -> int:
    """The input pair query ``i`` reads."""
    return 0


class Outcome:
    def __init__(self, result, group):
        self.result, self.group = result, group

    def rows_out(self) -> int:
        """This rank's output rows."""
        return int(self.result.num_rows)

    def fetch(self):
        """On rank 0 the valid rows of every rank in rank order, in host
        memory, for the check; None on the others. Every rank takes part:
        the blocks go to rank 0 over the harness's control group, so the
        check takes no device memory."""
        blocks = self.group.gather(self.result.data[: self.rows_out()].cpu().numpy())
        return None if blocks is None else np.concatenate(blocks, axis=0)


class Mode:
    sharded = True

    def __init__(self, config, traffic, seed, device, program, generator, group):
        d1, d2 = generator.make_pair(config, seed, 0, device)
        schema = config["schema"]
        self.device, self.program, self.group = device, program, group
        self.rows_per_table = (d1.shape[0], d2.shape[0])  # whole tables
        self.out_ncol = d1.shape[1] + d2.shape[1] - 1
        self.item_bytes = d1.element_size()
        self.t1 = program.row_block(d1, schema["table1"], group.rank, group.world)
        self.t2 = program.row_block(d2, schema["table2"], group.rank, group.world)
        del d1, d2
        self.local_rows_per_table = (int(self.t1.num_rows), int(self.t2.num_rows))

    def pair(self, i: int) -> int:
        return pair_of(None, i)

    def query(self, i: int, engine_config, span) -> Outcome:
        with span("query"):
            result = self.program.DistributedQueryPipeline(engine_config,
                                                           device=self.device).run_tables(
                self.t1, self.t2)
        return Outcome(result, self.group)
