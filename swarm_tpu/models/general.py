"""d>=2 engine (reference: src/algo.cc).

Sequential seed/subseed growth over an order-maintained amplicon list,
with two batched device-friendly screens per subseed:
  1. qgram parity-profile lower bounds over the remaining pool;
  2. exact cost-space alignment diffs (search-kernel semantics) for
     survivors.
Both are pure functions of (subseed, target) so they batch freely; the
host replays the reference's array-rotation bookkeeping, which defines
member output order.
"""

import os

import numpy as np

from ..db import Db
from ..ops.neighbors import pad_codes
from ..ops.nw_scalar import nw
from ..ops.qgram import qgram_mindiff, qgram_profiles
from ..ops.search import search_diffs_ref, set_bit_mode
from ..params import Parameters
from ..progress import Progress


def algo_run(p: Parameters, db: Db, progress: Progress) -> None:
    n = len(db)
    ua = p.opt_usearch_abundance
    aa = p.opt_append_abundance
    d = p.opt_differences
    abundances = db.abundances
    lengths = db.lengths

    from .. import _native

    backend = os.environ.get("SWARM_TPU_BACKEND", "auto")
    # engine selection: "network" = device int8 qgram join + exact
    # diffs + graph-driven clustering replay (auto above 16k amplicons
    # on an accelerator in the 8-bit regime; the 16k crossover is not
    # yet measured on the GPU); "native" = the all-host C seed/subseed
    # loop; the Python loop (with optional device screens) stays as
    # the oracle and as the explicit SWARM_TPU_D2_ENGINE=python/device
    # path
    engine = os.environ.get("SWARM_TPU_D2_ENGINE", "auto")
    bit_mode = set_bit_mode(d, p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend)
    max_len = max(int(db.longest), 1)

    if engine == "auto":
        engine = "native" if _native.available() else "python"
        if (
            _native.available() and bit_mode == 8 and n >= 16384
            and backend in ("auto", "jax", "jax_probe", "jax_shard")
        ):
            from ..device import device_platform

            if device_platform() != "cpu":
                engine = "network"
    if engine == "network" and not (_native.available() and bit_mode == 8):
        # the network formulation needs the native diff kernel and the
        # pure-pair 8-bit semantics (the 16-bit artifact's diffs depend
        # on the channel schedule, src/search16.cc)
        engine = "native" if _native.available() else "python"
    from .. import metrics

    metrics.engine(d2=engine)

    if engine == "network":
        progress.init("Find qgram vects: ", n)
        from ..ops.d2_network import D2NetworkEngine

        eng = D2NetworkEngine(db, d, threads=p.opt_threads)
        from ..progress import replay_range

        replay_range(progress, n)
        progress.done()
        _algo_run_network(p, db, progress, eng, n, d)
        return

    if _native.available() and engine == "native":
        # offset-based arena throughout: no [n, round_up(longest)]
        # matrix, so one multi-Mnt sequence costs only its own bytes
        progress.init("Find qgram vects: ", n)
        profiles = _native.qgram_profiles_arena(
            db.codes, db.offsets, db.lengths
        )
        from ..progress import replay_range

        replay_range(progress, n)
        progress.done()
        _algo_run_native(p, db, progress, None, profiles, bit_mode, n, d)
        return

    padded = pad_codes(db.codes, db.offsets, db.lengths, max_len)

    progress.init("Find qgram vects: ", n)
    profiles = qgram_profiles(padded, lengths)
    # reference updates per sequence (src/db.cc:838); replay the same
    # milestone writes after the batched pass
    from ..progress import replay_range

    replay_range(progress, n)
    progress.done()

    # device screening: reject pairs whose alignment cost already proves
    # diff > d, then re-run the few survivors through the exact host
    # kernel (see ops/search_jax.py for the soundness argument)
    device_aligner = None
    if engine == "device" or backend in ("jax", "jax_probe", "jax_shard") or (
        backend == "auto" and n * max_len >= 4_000_000
    ):
        from ..ops.search_jax import DeviceAligner

        device_aligner = DeviceAligner(padded, lengths)
    cutoff = d * max(p.penalty_mismatch, p.penalty_gapopen + p.penalty_gapextend)

    def _exact_diffs(seed_id: int, target_ids: np.ndarray, compute=None):
        """Diffs for the FULL ordered search_do target list.

        The reference binary's kernel boundary artifact makes each
        target's diffs depend on where the channel scheduler placed its
        blocks within the whole list (ops/search.py:search_diffs_ref),
        so even screened-out targets must stay in the list; `compute`
        only skips their DP."""
        qseq = padded[seed_id, : lengths[seed_id]]
        rows = padded[target_ids]
        lens = lengths[target_ids]
        batch_max = int(lens.max())
        _, diffs, _ = search_diffs_ref(
            qseq,
            rows[:, :batch_max],
            lens,
            p.penalty_mismatch,
            p.penalty_gapopen,
            p.penalty_gapextend,
            bit_mode,
            compute,
        )
        return diffs

    def aligner(seed_id: int, target_ids: np.ndarray):
        if (
            device_aligner is None
            or len(target_ids) < device_aligner.MIN_DEVICE_BATCH
        ):
            return _exact_diffs(seed_id, target_ids)
        scr = device_aligner.scores(
            seed_id, target_ids,
            p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend,
        )
        # sound prune vs the artifact kernel: an accepted pair's walked
        # path is a valid alignment with <= d diffs, whose true cost
        # bounds the ideal score by d*max(mm, go+ge)
        return _exact_diffs(seed_id, target_ids, compute=scr <= cutoff)

    # ordering state as parallel arrays (the reference's in-place
    # partitioned amplicon array, src/algo.cc:329-708); pool scans are
    # vectorized instead of per-element loops
    order = np.arange(n, dtype=np.int64)       # ampliconid per position
    diffest = np.zeros(n, dtype=np.int64)
    swarmid_arr = np.zeros(n, dtype=np.int64)
    gen_arr = np.zeros(n, dtype=np.int64)
    rad_arr = np.zeros(n, dtype=np.int64)
    _state = (order, diffest, swarmid_arr, gen_arr, rad_arr)
    ab_i64 = np.ascontiguousarray(abundances, dtype=np.int64)

    from .. import _native

    def rotate(target: int, pos: int) -> None:
        """Move position target to pos (pos <= target), shifting
        [pos, target) right — the reference's memmove rotation."""
        if target == pos:
            return
        for arr in _state:
            tmp = arr[target]
            seg = arr[pos:target].copy()
            arr[pos + 1 : target + 1] = seg
            arr[pos] = tmp

    structure_out = []
    uclust_out = []
    stats_out = []

    largestswarm = 0
    maxgenerations = 0
    swarmid = 0
    seeded = 0
    swarmed = 0

    progress.init("Clustering:       ", n)
    while seeded < n:
        swarmid += 1

        swarmsize = 1
        amplicons_copies = 0
        singletons = 0
        hits = []
        maxradius = 0
        maxgen = 1

        seedindex = seeded
        seeded += 1
        swarmid_arr[seedindex] = swarmid
        seedampliconid = int(order[seedindex])
        hits.append(seedampliconid)

        abundance = int(abundances[seedampliconid])
        amplicons_copies += abundance
        if abundance == 1:
            singletons += 1
        swarmed += 1

        # gen-1 candidates: whole remaining pool (abundance rule; the
        # pool region stays abundance-sorted, so the rule never filters
        # here — kept for exactness with -n semantics)
        if _native.available():
            t_pos, t_ids, _ = _native.d2_gen1_screen(
                profiles, order, ab_i64, diffest, swarmed,
                seedampliconid, abundance, p.opt_no_cluster_breaking, d,
            )
            targetindices = t_pos.tolist()
            targetampliconids = t_ids
        else:
            pool_slice = order[swarmed:]
            if p.opt_no_cluster_breaking:
                pool_ids = pool_slice
            else:
                pool_ids = pool_slice[abundances[pool_slice] <= abundance]
            qdiffs = qgram_mindiff(profiles, seedampliconid, pool_ids)

            diffest[swarmed : swarmed + len(pool_ids)] = qdiffs
            hit_rel = np.nonzero(qdiffs <= d)[0]
            targetindices = (swarmed + hit_rel).tolist()
            targetampliconids = pool_ids[hit_rel].astype(np.int64)

        if targetindices:
            diffs = aligner(seedampliconid, targetampliconids)

            for t_id in range(len(targetampliconids)):
                diff = int(diffs[t_id])
                if diff > d:
                    continue
                target = targetindices[t_id]
                # rotate target to the first unswarmed position
                if target > swarmed:
                    rotate(target, swarmed)
                swarmid_arr[swarmed] = swarmid
                gen_arr[swarmed] = 1
                rad_arr[swarmed] = diff
                maxradius = max(maxradius, diff)
                poolampliconid = int(order[swarmed])
                hits.append(poolampliconid)

                if p.opt_internal_structure:
                    structure_out.append(
                        f"{db.print_id_noabundance(seedampliconid, ua)}\t"
                        f"{db.print_id_noabundance(poolampliconid, ua)}\t"
                        f"{diff}\t{swarmid}\t1\n"
                    )

                abundance = int(abundances[poolampliconid])
                amplicons_copies += abundance
                if abundance == 1:
                    singletons += 1
                swarmsize += 1
                swarmed += 1

            while seeded < swarmed:
                subseed_pos = seeded
                subseed_amp = int(order[subseed_pos])
                subseed_radius = int(rad_arr[subseed_pos])
                subseed_generation = int(gen_arr[subseed_pos])
                seeded += 1

                subseedabundance = int(abundances[subseed_amp])
                if _native.available():
                    t_pos, t_ids = _native.d2_subseed_screen(
                        profiles, order, ab_i64, diffest, swarmed,
                        subseed_amp, subseed_radius + d, subseedabundance,
                        p.opt_no_cluster_breaking, d,
                    )
                    targetindices = t_pos.tolist()
                    targetampliconids = t_ids
                else:
                    mask = diffest[swarmed:] <= subseed_radius + d
                    if not p.opt_no_cluster_breaking:
                        mask &= abundances[order[swarmed:]] <= subseedabundance
                    sub_rel = np.nonzero(mask)[0]
                    sub_ids = order[swarmed + sub_rel]

                    qdiffs2 = qgram_mindiff(profiles, subseed_amp, sub_ids)
                    hit_rel = np.nonzero(qdiffs2 <= d)[0]
                    targetindices = (swarmed + sub_rel[hit_rel]).tolist()
                    targetampliconids = sub_ids[hit_rel].astype(np.int64)

                if not len(targetindices):
                    continue

                diffs = aligner(subseed_amp, targetampliconids)

                for t_id in range(len(targetampliconids)):
                    diff = int(diffs[t_id])
                    if diff > d:
                        continue
                    target = targetindices[t_id]

                    # find correct position: keep the newest generation
                    # ordered by amplicon id (src/algo.cc:205-219)
                    pos = swarmed
                    targetampliconid = int(order[target])
                    while (
                        pos > seeded
                        and order[pos - 1] > targetampliconid
                        and gen_arr[pos - 1] > subseed_generation
                    ):
                        pos -= 1

                    if target > pos:
                        rotate(target, pos)
                    swarmid_arr[pos] = swarmid
                    gen_arr[pos] = subseed_generation + 1
                    maxgen = max(maxgen, subseed_generation + 1)
                    rad_arr[pos] = subseed_radius + diff
                    maxradius = max(maxradius, subseed_radius + diff)

                    poolampliconid = int(order[pos])
                    hits.append(poolampliconid)

                    if p.opt_internal_structure:
                        structure_out.append(
                            f"{db.print_id_noabundance(subseed_amp, ua)}\t"
                            f"{db.print_id_noabundance(poolampliconid, ua)}\t"
                            f"{diff}\t{swarmid}\t{subseed_generation + 1}\n"
                        )

                    abundance = int(abundances[poolampliconid])
                    amplicons_copies += abundance
                    if abundance == 1:
                        singletons += 1
                    swarmsize += 1
                    swarmed += 1

        largestswarm = max(largestswarm, swarmsize)
        maxgenerations = max(maxgenerations, maxgen)

        if p.uclustfile is not None:
            seed_id_str = db.print_id(seedampliconid, ua, aa)
            uclust_out.append(
                f"C\t{swarmid - 1}\t{swarmsize}\t*\t*\t*\t*\t*\t{seed_id_str}\t*\n"
            )
            uclust_out.append(
                f"S\t{swarmid - 1}\t{lengths[seedampliconid]}\t*\t*\t*\t*\t*\t"
                f"{seed_id_str}\t*\n"
            )
            qseq = db.sequence_codes(seedampliconid)
            for hit in hits[1:]:
                dseq = db.sequence_codes(hit)
                nwdiff, alen, cigar = nw(
                    dseq, qseq, p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend
                )
                percentid = 100.0 * (alen - nwdiff) / alen
                uclust_out.append(
                    f"H\t{swarmid - 1}\t{lengths[hit]}\t{percentid:.1f}\t+\t0\t0\t"
                    f"{cigar if nwdiff > 0 else '='}\t"
                    f"{db.print_id(hit, ua, aa)}\t{seed_id_str}\n"
                )

        if p.statsfile is not None:
            abundance = int(abundances[seedampliconid])
            stats_out.append(
                f"{swarmsize}\t{amplicons_copies}\t"
                f"{db.print_id_noabundance(seedampliconid, ua)}\t"
                f"{abundance}\t{singletons}\t{maxgen}\t{maxradius}\n"
            )
        progress.update(seeded)
    progress.done()

    if p.opt_internal_structure:
        p.internal_structure_file.write("".join(structure_out))
    if p.uclustfile is not None:
        p.uclustfile.write("".join(uclust_out))
    if p.statsfile is not None:
        p.statsfile.write("".join(stats_out))

    # swarms output
    if n != 0:
        out = []
        if p.opt_mothur:
            out.append(f"swarm_{p.opt_differences}\t{swarmid}\t")
            previous_id = swarmid_arr[0]
            out.append(db.print_id(int(order[0]), ua, aa))
            for i in range(1, n):
                current_id = swarmid_arr[i]
                out.append("," if current_id == previous_id else "\t")
                out.append(db.print_id(int(order[i]), ua, aa))
                previous_id = current_id
            out.append("\n")
        else:
            previous_id = swarmid_arr[0]
            out.append(db.print_id(int(order[0]), ua, aa))
            for i in range(1, n):
                current_id = swarmid_arr[i]
                out.append(" " if current_id == previous_id else "\n")
                out.append(db.print_id(int(order[i]), ua, aa))
                previous_id = current_id
            out.append("\n")
        p.outfile.write("".join(out))

    # seeds
    if p.opt_seeds and n != 0:
        _write_seeds(p, db, progress, order, swarmid_arr, n)

    p.logfile.write("\n")
    p.logfile.write(f"Number of swarms:  {swarmid}\n")
    p.logfile.write(f"Largest swarm:     {largestswarm}\n")
    p.logfile.write(f"Max generations:   {maxgenerations}\n")


def _algo_run_network(p, db, progress, eng, n, d):
    """Network-engine path: bulk device qgram screen + native exact
    diffs produce the directed edge list; the graph-driven C replay
    (swarm_native.c: algo_cluster_graph) reproduces algo_cluster's
    attachment order exactly; output writers are shared."""
    from .. import _native

    want_structure = bool(p.opt_internal_structure or p.uclustfile is not None)
    adj_start, adj_count, adj_to, adj_diff, n_screened, n_survivors = (
        eng.build_adjacency(
            p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend,
            p.opt_no_cluster_breaking,
        )
    )
    res = _native.algo_cluster_graph(
        adj_start, adj_count, adj_to, adj_diff, db.abundances,
        want_structure,
    )

    from .. import metrics

    metrics.record(
        qgram_screen_comparisons=n * (n - 1) // 2,
        alignment_comparisons=n_survivors,
    )
    _write_d2_results(p, db, progress, res, n)


def _algo_run_native(p, db, progress, padded, profiles, bit_mode, n, d):
    """Native-engine path: the whole seed/subseed loop runs in C
    (swarm_native.c: algo_cluster); Python replays progress and formats
    the outputs from the returned arrays."""
    from .. import _native

    lengths = np.ascontiguousarray(db.lengths, dtype=np.int64)
    want_structure = bool(p.opt_internal_structure or p.uclustfile is not None)

    res = _native.algo_cluster(
        profiles, db.codes, db.offsets, lengths, db.abundances, d,
        p.penalty_mismatch, p.penalty_gapopen, p.penalty_gapextend,
        bit_mode, p.opt_no_cluster_breaking, want_structure,
    )

    from .. import metrics

    metrics.record(
        qgram_screen_comparisons=res["comparisons"]["gen1_screen"]
        + res["comparisons"]["subseed_scan"],
        alignment_comparisons=res["comparisons"]["alignments"],
    )
    _write_d2_results(p, db, progress, res, n)


def _write_d2_results(p, db, progress, res, n):
    """Format every d>=2 output stream from the engine result arrays
    (reference writers: src/algo.cc:608-694 and the inline uclust/stats
    streaming)."""
    from .. import _native

    ua = p.opt_usearch_abundance
    aa = p.opt_append_abundance
    lengths = np.ascontiguousarray(db.lengths, dtype=np.int64)

    progress.init("Clustering:       ", n)
    from ..progress import replay_values

    replay_values(progress, res["swarm_bound"])
    progress.done()

    order = res["order"]
    swarmid_arr = res["swarmid"]
    swarmcount = res["swarmcount"]

    if p.opt_internal_structure:
        out = []
        sid = 0
        bounds = res["swarm_bound"]
        child_cum = np.cumsum(res["swarm_size"] - 1)
        for k in range(len(res["struct_parent"])):
            while sid < swarmcount and k >= child_cum[sid]:
                sid += 1
            out.append(
                f"{db.print_id_noabundance(int(res['struct_parent'][k]), ua)}\t"
                f"{db.print_id_noabundance(int(res['struct_child'][k]), ua)}\t"
                f"{int(res['struct_diff'][k])}\t{sid + 1}\t"
                f"{int(res['struct_gen'][k])}\n"
            )
        p.internal_structure_file.write("".join(out))

    if p.uclustfile is not None:
        out = []
        child_off = 0
        for s in range(swarmcount):
            seed_amp = int(res["swarm_seed"][s])
            size = int(res["swarm_size"][s])
            seed_id_str = db.print_id(seed_amp, ua, aa)
            out.append(f"C\t{s}\t{size}\t*\t*\t*\t*\t*\t{seed_id_str}\t*\n")
            out.append(
                f"S\t{s}\t{lengths[seed_amp]}\t*\t*\t*\t*\t*\t"
                f"{seed_id_str}\t*\n"
            )
            qseq = db.sequence_codes(seed_amp)
            for k in range(child_off, child_off + size - 1):
                hit = int(res["struct_child"][k])
                dseq = db.sequence_codes(hit)
                nwdiff, alen, cigar = nw(
                    dseq, qseq, p.penalty_mismatch, p.penalty_gapopen,
                    p.penalty_gapextend,
                )
                percentid = 100.0 * (alen - nwdiff) / alen
                out.append(
                    f"H\t{s}\t{lengths[hit]}\t{percentid:.1f}\t+\t0\t0\t"
                    f"{cigar if nwdiff > 0 else '='}\t"
                    f"{db.print_id(hit, ua, aa)}\t{seed_id_str}\n"
                )
            child_off += size - 1
        p.uclustfile.write("".join(out))

    if p.statsfile is not None:
        out = []
        for s in range(swarmcount):
            seed_amp = int(res["swarm_seed"][s])
            out.append(
                f"{int(res['swarm_size'][s])}\t{int(res['swarm_copies'][s])}\t"
                f"{db.print_id_noabundance(seed_amp, ua)}\t"
                f"{int(db.abundances[seed_amp])}\t"
                f"{int(res['swarm_singletons'][s])}\t"
                f"{int(res['swarm_maxgen'][s])}\t{int(res['swarm_maxrad'][s])}\n"
            )
        p.statsfile.write("".join(out))

    # swarms output
    if n != 0:
        if p.opt_mothur:
            out = [f"swarm_{p.opt_differences}\t{swarmcount}\t"]
            previous_id = swarmid_arr[0]
            out.append(db.print_id(int(order[0]), ua, aa))
            for i in range(1, n):
                current_id = swarmid_arr[i]
                out.append("," if current_id == previous_id else "\t")
                out.append(db.print_id(int(order[i]), ua, aa))
                previous_id = current_id
            out.append("\n")
            p.outfile.write("".join(out))
        else:
            bounds = np.concatenate(
                ([0], np.asarray(res["swarm_bound"], dtype=np.int64))
            )
            attached = np.zeros(swarmcount, dtype=np.uint8)
            data = _native.write_swarms_plain(
                _native.HeaderArena(db), aa, ua, order, bounds, attached
            )
            from ..cli import write_blob

            write_blob(p.outfile, data)

    if p.opt_seeds and n != 0:
        _write_seeds(p, db, progress, order, swarmid_arr, n)

    p.logfile.write("\n")
    p.logfile.write(f"Number of swarms:  {swarmcount}\n")
    p.logfile.write(f"Largest swarm:     {res['largest']}\n")
    p.logfile.write(f"Max generations:   {res['maxgen']}\n")


def _sort_seeds_stdcxx(db, seeds):
    """Sort [(seed, mass), ...] exactly as the reference's std::sort
    does (src/algo.cc:161-183): mass descending, strcmp == -1 ties,
    introsort-defined order for incomparable pairs."""
    from .. import _native

    if _native.available():
        mass = np.array([m for _, m in seeds], dtype=np.int64)
        seed = np.array([s for s, _ in seeds], dtype=np.int64)
        if _native.sort_seeds_stdcxx(mass, seed, _native.HeaderArena(db)):
            return list(zip(seed.tolist(), mass.tolist()))

    from ..stdcxx_sort import stdcxx_sort

    headers = db.headers

    def strcmp_glibc(a: bytes, b: bytes) -> int:
        """glibc strcmp: difference of the first differing unsigned bytes."""
        for x, y in zip(a, b):
            if x != y:
                return x - y
        return len(a) - len(b)

    def lt(lhs, rhs) -> bool:
        if lhs[1] != rhs[1]:
            return lhs[1] > rhs[1]
        return strcmp_glibc(headers[lhs[0]], headers[rhs[0]]) == -1

    seeds = list(seeds)
    stdcxx_sort(seeds, lt)
    return seeds


def _write_seeds(p, db, progress, order, swarmid_arr, n):
    """Collect per-swarm seeds+mass, sort, write (src/algo.cc:123-202).

    The reference's tie comparator tests `strcmp(...) == -1`, which with
    glibc is only true when the first differing bytes differ by exactly
    -1; other equal-mass pairs compare "equal" in BOTH directions, so
    the comparator is not a strict weak order and the output order of
    such ties is defined by std::sort's algorithm itself. We replicate
    libstdc++'s introsort exactly (C fast path sort_seeds_stdcxx;
    Python mirror in stdcxx_sort.py)."""
    ua = p.opt_usearch_abundance

    progress.init("Collecting seeds:    ", n)
    seeds = []
    mass = 0
    previous_id = swarmid_arr[0]
    seed = int(order[0])
    mass += int(db.abundances[seed])
    for i in range(1, n):
        current_id = swarmid_arr[i]
        if current_id != previous_id:
            seeds.append((seed, mass))
            mass = 0
            seed = int(order[i])
        mass += int(db.abundances[int(order[i])])
        previous_id = current_id
        progress.update(i)
    seeds.append((seed, mass))
    # the reference's collect_seeds never calls progress_done
    # (src/algo.cc:123-158): no "100%" line in -l mode, no newline on
    # stderr — the next phase's init overwrites the line in place

    progress.init("Sorting seeds:    ", len(seeds))
    seeds = _sort_seeds_stdcxx(db, seeds)
    progress.done()

    progress.init("Writing seeds:    ", len(seeds))
    out = []
    for ticker, (seed, swarm_mass) in enumerate(seeds):
        out.append(">")
        out.append(db.print_id_with_new_abundance(seed, swarm_mass, ua))
        out.append("\n")
        out.append(db.sequence_string(seed))
        out.append("\n")
        progress.update(ticker)
    p.seeds_file.write("".join(out))
    progress.done()
