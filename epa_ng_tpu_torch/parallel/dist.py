"""Multi-process coordination: process topology and jplace shard merging.

Replaces the reference's MPI layer (src/net/): query sharding is pure
offset arithmetic (reference local_seq_package,
src/net/epa_mpi_util.cpp:10-30), handled by the readers; result merging
concatenates per-process jplace fragments into one document (replacing
the MPI-IO collective shared-file writes of src/io/jplace_writer.hpp:92-132).

For a real multi-process run the CLI's ``--distributed`` initializes a
``torch.distributed`` process group (gloo: it carries the only
cross-process traffic, a barrier and one float per process, and two
processes may share one card); ``process_info`` then reflects it.
"""

from __future__ import annotations

import os


def _group_size() -> tuple[int, int] | None:
    """(rank, world size) of the initialized default process group, or
    None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of this process in the job.

    Env overrides EPA_NG_TPU_PROCESS_INDEX / EPA_NG_TPU_PROCESS_COUNT allow
    driving the sharded path without a process group (tests, plain
    rank-per-host launches with an external merger); then the initialized
    ``torch.distributed`` group's rank and size; else (0, 1)."""
    idx = os.environ.get("EPA_NG_TPU_PROCESS_INDEX")
    cnt = os.environ.get("EPA_NG_TPU_PROCESS_COUNT")
    if idx is not None and cnt is not None:
        return int(idx), int(cnt)
    return _group_size() or (0, 1)


def merge_jplace_shards(outdir: str, out_file: str, count: int,
                        tree_string: str, invocation: str,
                        final_dir: str | None = None):
    """Concatenate per-process fragment shards into the final jplace
    document. Called on the coordinator (process 0) after all processes
    finished. ``outdir`` holds the shards (possibly --tmp); ``final_dir``
    the result.

    FAILS LOUDLY on a missing or truncated shard: a rank that died after
    the barrier — or a mis-set --tmp — must not yield a valid-looking
    document with silently missing queries (the reference's MPI-IO
    collective write cannot lose a rank silently either,
    src/io/jplace_writer.hpp:92-132). Each shard carries a ``.count``
    sidecar written by JplaceWriter.close with its query count; the merge
    verifies the fragment's pquery count against it."""
    from epa_ng_tpu_torch.io.jplace import _trailer, write_header
    missing = [i for i in range(count) if not os.path.exists(
        os.path.join(outdir, f"{out_file}.shard{i}"))]
    if missing:
        raise RuntimeError(
            f"jplace merge: missing shard(s) {missing} of {count} in "
            f"{outdir!r} — a worker process died or wrote to a different "
            "--tmp directory; refusing to emit a partial result")
    final = os.path.join(final_dir or outdir, out_file)
    # write to a temp name and rename on success: a verification failure
    # below must not leave a half-written document at the result path
    tmp_final = final + ".merging"
    try:
        with open(tmp_final, "w") as out:
            write_header(out, tree_string)
            wrote_any = False
            for i in range(count):
                shard = os.path.join(outdir, f"{out_file}.shard{i}")
                with open(shard) as f:
                    content = f.read()
                count_file = shard + ".count"
                if not os.path.exists(count_file):
                    # the sidecar is written by JplaceWriter.close(): its
                    # absence means the rank died mid-run (or the file is
                    # foreign) — the shard's completeness is unverifiable
                    raise RuntimeError(
                        f"jplace merge: shard {i} has no .count sidecar "
                        "(worker crashed before closing its writer?); "
                        "refusing to emit a possibly-partial result")
                with open(count_file) as cf:
                    expected = int(cf.read().strip() or "0")
                # every pquery fragment carries exactly one "n" name list
                got = content.count('"n": [')
                if got != expected:
                    raise RuntimeError(
                        f"jplace merge: shard {i} is truncated: has {got} "
                        f"pqueries, its writer recorded {expected}")
                if not content:
                    continue
                if wrote_any:
                    out.write(",\n")
                out.write(content)
                wrote_any = True
            out.write(_trailer(invocation))
        os.replace(tmp_final, final)
    except BaseException:
        if os.path.exists(tmp_final):
            os.remove(tmp_final)
        raise
    for i in range(count):
        for path in (os.path.join(outdir, f"{out_file}.shard{i}"),
                     os.path.join(outdir, f"{out_file}.shard{i}.count")):
            if os.path.exists(path):
                os.remove(path)
    return final


def barrier():
    """Cross-process barrier: ``torch.distributed.barrier()`` when the
    process group has more than one rank, else nothing."""
    group = _group_size()
    if group is not None and group[1] > 1:
        import torch.distributed as dist
        dist.barrier()


def all_gather_floats(x: float) -> list | None:
    """``x`` from every rank of the process group, in rank order
    (``torch.distributed.all_gather_object``), or None when there is no
    group of more than one rank."""
    group = _group_size()
    if group is None or group[1] < 2:
        return None
    import torch.distributed as dist
    out = [None] * group[1]
    dist.all_gather_object(out, float(x))
    return out
