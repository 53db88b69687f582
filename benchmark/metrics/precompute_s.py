"""Host clock around the port's precompute in set-up (tables, physics,
ray constants, compaction), each span ending in a synchronize."""


def read(run):
    spans = [s for n, s in run.phases.items() if n.startswith('precompute')]
    return sum(spans) if spans else None
