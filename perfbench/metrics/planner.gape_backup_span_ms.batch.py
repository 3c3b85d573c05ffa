"""Host milliseconds of one MDP-GapE episode's backup: the mean of the
program's ``gape.backup`` spans in the spanned pass's whole plans (the H
decision and H chance backups, the chance backups' Newton solves and their
read-backs among them). None where the program has no such span."""
from perfbench.pbcore.spans import mean_span_ms


def read(record):
    return mean_span_ms(record, "gape.backup")
