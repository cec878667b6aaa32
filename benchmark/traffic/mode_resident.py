"""Traffic mode ``resident``: the configuration's table pair is made on the
card once; every query runs `QueryPipeline.run_tables` on it, and its
result stays on the card (it is usable when `run_tables` returns, which
has waited for the row count)."""

from __future__ import annotations


def pair_of(traffic: dict, i: int) -> int:
    """The input pair query ``i`` reads."""
    return 0


class Outcome:
    def __init__(self, result):
        self.result = result

    def rows_out(self) -> int:
        return int(self.result.num_rows)

    def fetch(self):
        """The result's rows in host memory, for the check."""
        return self.result.data[: self.rows_out()].cpu().numpy()


class Mode:
    def __init__(self, config, traffic, seed, device, program, generator):
        d1, d2 = generator.make_pair(config, seed, 0, device)
        schema = config["schema"]
        self.device, self.program = device, program
        self.t1 = program.table(d1, schema["table1"])
        self.t2 = program.table(d2, schema["table2"])
        self.rows_per_table = (d1.shape[0], d2.shape[0])
        self.out_ncol = d1.shape[1] + d2.shape[1] - 1
        self.item_bytes = d1.element_size()

    def pair(self, i: int) -> int:
        return pair_of(None, i)

    def query(self, i: int, engine_config, span) -> Outcome:
        with span("query"):
            result = self.program.QueryPipeline(engine_config, self.device).run_tables(
                self.t1, self.t2)
        return Outcome(result)
