"""exact_chunk_pct: the program's own counts ``fused.chunks`` (chunks
dispatched to the fused step) and ``fused.exact_chunks`` (those the fused
path surrendered to the host-orchestrated exact placement): the share, in
percent, of the window's fused chunks that fell back."""

COUNTS = ("fused.chunks", "fused.exact_chunks")


def read(run):
    counts = run.program_counts or {}
    chunks = counts.get("fused.chunks", 0)
    if not chunks:
        return None
    return 100.0 * counts.get("fused.exact_chunks", 0) / chunks
