"""95th percentile of the engine's own TTFTs (submit to first token, its
``ttfts``) of the prefills in the window; the gap to serve.ttft_p95_ms is
the worker's request handling and the generator's lateness."""

from portbench import measure


def read(run):
    t = run.out["engine_ttfts"]
    return 1e3 * measure.quantile(t, 0.95) if t else None
