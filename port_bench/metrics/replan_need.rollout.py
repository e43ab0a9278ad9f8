"""100 x the program's counter `replan.rows_needed` (rows the env step
marks as needed, `need.sum()`) over `replan.rows_run` (K, the rows each K1
launch runs), over the traced passes: the share of K1's work the step uses.
The judge's `replan_overflow` check guards the other side (needed rows past
the budget)."""
from port_bench import spans


def read(m):
    return spans.ratio("replan.rows_needed", "replan.rows_run")
