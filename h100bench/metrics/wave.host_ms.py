"""wave.host_ms: the host's ms from the call of ``render_wave`` to its
return, the mean over the window's frames (the benchmark's span)."""


def read(ctx):
    waves = ctx.get("spans", {}).get("wave")
    return sum(waves) / len(waves) * 1e3 if waves else None
