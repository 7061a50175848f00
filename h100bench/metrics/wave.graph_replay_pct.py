"""wave.graph_replay_pct: the share of the traced frames' waves that ran
as one CUDA graph, 100 x the mean of the program's ``wave.graph_replays``
counts (1 a wave that launched a captured graph, 0 one launched kernel by
kernel); None where the program keeps none."""
from h100bench import spans


def read(ctx):
    kept = spans.port_counts(ctx).get("wave.graph_replays")
    if not kept:
        return None
    return 100.0 * sum(kept) / len(kept)
