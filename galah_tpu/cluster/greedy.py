"""Greedy quality-ordered clustering core.

Behavioral parity with the reference's clusterer (src/clusterer.rs:14-487):

1. precluster distances (sparse, above the precluster threshold);
2. single-linkage partition into preclusters via union-find
   (src/clusterer.rs:452-487);
3. per precluster, greedy representative selection in genome-priority
   order (the input list is already quality-ordered;
   src/clusterer.rs:182-259) and best-ANI membership assignment
   (src/clusterer.rs:350-449).

Differences by design (accelerator-first):
- preclusters are processed sequentially on host (deterministic output
  order instead of rayon's nondeterministic push order), with the ANI
  evaluations batched to the device;
- the reference's parallel stop-early scan (src/clusterer.rs:276-296)
  becomes whole-batch evaluation: the clusterer cache may hold *more*
  entries, but every stored value is identical, so cluster results are
  unchanged while device utilization is far better.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

from typing import TYPE_CHECKING

from galah_tpu.cluster.cache import SortedPairDistanceCache
from galah_tpu.cluster.union_find import DisjointSet

if TYPE_CHECKING:  # avoid a runtime circular import via engines.base
    from galah_tpu.engines.base import ClusterDistanceFinder, PreclusterDistanceFinder

logger = logging.getLogger(__name__)


def cluster(
    genomes: Sequence[str],
    preclusterer: "PreclusterDistanceFinder",
    clusterer: "ClusterDistanceFinder",
    cluster_contigs: bool = False,
    contig_names: Optional[Sequence[str]] = None,
    reference_genomes: Optional[Sequence[str]] = None,
) -> List[List[int]]:
    """Cluster genomes (given in priority order); returns clusters as
    lists of indices into `genomes` with the representative first."""
    clusterer.initialise()

    pre_name = preclusterer.method_name()
    clu_name = clusterer.method_name()
    logger.info("Preclustering with %s and clustering with %s", pre_name, clu_name)

    skip_clusterer = False
    if pre_name == clu_name:
        logger.info("Precluster and cluster methods are the same; reusing ANI values")
        skip_clusterer = True

    if cluster_contigs:
        if not _supports_contigs(preclusterer):
            raise ValueError(f"{pre_name} does not support contig comparisons.")
        skip_clusterer = True

    if reference_genomes is not None:
        cache = preclusterer.distances_with_references(genomes, reference_genomes)
    elif cluster_contigs:
        cache = preclusterer.distances_contigs(genomes, contig_names)
    else:
        cache = preclusterer.distances(genomes)

    units = contig_names if cluster_contigs else genomes
    logger.info("Preclustering ..")
    preclusters = _partition_sketches(len(units), cache)
    # Bigger preclusters first; stable sort keeps first-seen order on
    # ties (src/clusterer.rs:79).
    preclusters.sort(key=len, reverse=True)
    logger.info(
        "Found %d preclusters. The largest contained %d genomes",
        len(preclusters),
        len(preclusters[0]) if preclusters else 0,
    )

    logger.info("Finding representative genomes and assigning all genomes to these ..")
    local_caches = _bucket_cache(preclusters, cache)
    all_clusters: List[List[int]] = []
    for precluster_id, original_indices in enumerate(preclusters):
        local_cache = local_caches[precluster_id]
        local_units = [units[i] for i in original_indices]
        logger.debug(
            "Clustering precluster %d with indices %s", precluster_id, original_indices
        )
        adj = _adjacency(local_cache, len(local_units))
        reps, calculated = _find_precluster_cluster_representatives(
            clusterer, local_cache, local_units, skip_clusterer, adj
        )
        clusters = _find_precluster_cluster_memberships(
            clusterer, reps, local_cache, local_units, calculated, adj
        )
        for c in clusters:
            all_clusters.append([original_indices[w] for w in c])
    return all_clusters


def _supports_contigs(preclusterer: "PreclusterDistanceFinder") -> bool:
    return getattr(preclusterer, "supports_contigs", True)


def _partition_sketches(n: int, cache: SortedPairDistanceCache) -> List[List[int]]:
    """Single-linkage partition from cache key presence
    (src/clusterer.rs:452-487)."""
    ds = DisjointSet(n)
    for (i, j), _ in cache.items():
        ds.join(i, j)
    return ds.sets()


def _bucket_cache(
    preclusters: List[List[int]], cache: SortedPairDistanceCache
) -> List[SortedPairDistanceCache]:
    """Build every precluster-local cache in ONE pass over the global
    cache. Equivalent to per-precluster `transform_ids`
    (src/sorted_pair_genome_distance_cache.rs:47-58) but O(E) total
    instead of O(sum m_p^2) — at a 100k-genome single precluster the
    quadratic scan is hours, the bucketing pass is seconds. Valid
    because single-linkage puts both endpoints of every cached pair in
    the same precluster by construction."""
    pos: dict = {}
    for p, ids in enumerate(preclusters):
        for a, g in enumerate(ids):
            pos[g] = (p, a)
    out = [SortedPairDistanceCache() for _ in preclusters]
    for (i, j), v in cache.items():
        pi, a = pos[i]
        pj, b = pos[j]
        assert pi == pj, f"pair ({i},{j}) spans preclusters {pi},{pj}"
        out[pi].insert((a, b), v)
    return out


def _find_precluster_cluster_representatives(
    clusterer: "ClusterDistanceFinder",
    precl_cache: SortedPairDistanceCache,
    genomes: Sequence[str],
    skip_clusterer: bool,
    adj: Optional[List[List[int]]] = None,
) -> Tuple[List[int], SortedPairDistanceCache]:
    """Greedy scan in genome-priority order (src/clusterer.rs:182-259).

    Returns (sorted rep indices, the clusterer-ANI cache to seed
    membership assignment with)."""
    reps: List[int] = []  # kept sorted ascending (BTreeSet parity)
    rep_set: set = set()
    clusterer_cache = SortedPairDistanceCache()
    threshold = clusterer.get_ani_threshold()
    # Candidates can only be cache neighbors, so scan i's adjacency
    # instead of every rep: O(E) total, not O(m^2) — the difference
    # between seconds and hours in a 100k-genome precluster. Ascending
    # neighbor order keeps iteration-order parity with the reference's
    # scan over the rep BTreeSet (src/clusterer.rs:194-204). The caller
    # passes the adjacency it already built (shared with membership
    # assignment — one O(E log E) build per precluster, not two).
    if adj is None:
        adj = _adjacency(precl_cache, len(genomes))

    for i in range(len(genomes)):
        # All current reps within precluster distance of genome i,
        # sorted ascending by precluster ANI (src/clusterer.rs:194-204;
        # sort is stable, so equal ANIs stay in ascending-index order).
        cands = []
        for j in adj[i]:
            if j in rep_set:
                got = precl_cache.get((i, j))
                cands.append((j, got[0]))
        cands.sort(key=lambda t: (t[1] is not None, t[1]))
        potential_refs = [j for j, _ in cands]

        if skip_clusterer:
            anis: List[Optional[float]] = []
            for j in potential_refs:
                got = precl_cache.get((j, i))
                # Option<Option<f32>>.flatten() (src/clusterer.rs:298-313)
                anis.append(got[0] if got is not None else None)
        else:
            # Whole-batch evaluation replaces the reference's parallel
            # stop-early scan; values are identical, so results match.
            anis = clusterer.calculate_ani_batch(
                [(genomes[j], genomes[i]) for j in potential_refs]
            )

        is_rep = True
        for j, ani in zip(potential_refs, anis):
            if ani is not None:
                if not skip_clusterer:
                    clusterer_cache.insert((j, i), ani)
                if ani >= threshold:
                    is_rep = False
        if is_rep:
            logger.debug("Genome designated representative: %d %s", i, genomes[i])
            _insort(reps, i)
            rep_set.add(i)

    if skip_clusterer:
        # Return all precluster ANIs: fixes the transitivity bug the
        # reference patched (src/clusterer.rs:252-258).
        return reps, _clone_cache(precl_cache)
    return reps, clusterer_cache


def _find_precluster_cluster_memberships(
    clusterer: "ClusterDistanceFinder",
    representatives: List[int],
    precl_cache: SortedPairDistanceCache,
    genomes: Sequence[str],
    calculated: SortedPairDistanceCache,
    adj: Optional[List[List[int]]] = None,
) -> List[List[int]]:
    """Assign each non-rep genome to its best-ANI representative
    (src/clusterer.rs:350-449)."""
    rep_to_index = {r: k for k, r in enumerate(representatives)}
    rep_set = set(representatives)
    result: List[List[int]] = [[r] for r in representatives]
    # Only cache neighbors can carry an ANI to a rep (every `calculated`
    # entry is a precl_cache pair by construction), so scan adjacency
    # instead of every rep — O(E), ascending order for tie parity with
    # the reference's scan over the rep set (src/clusterer.rs:408-444);
    # shared with the representative scan when the caller provides it.
    if adj is None:
        adj = _adjacency(precl_cache, len(genomes))

    # Compute all missing rep<->genome ANIs in one device batch
    # (the reference computes them per genome in parallel,
    # src/clusterer.rs:375-405).
    missing_pairs: List[Tuple[int, int]] = []
    for i in range(len(genomes)):
        if i in rep_set:
            continue
        for rep in adj[i]:
            if rep in rep_set and not calculated.contains_key((i, rep)):
                missing_pairs.append((i, rep))
    if missing_pairs:
        anis = clusterer.calculate_ani_batch(
            [(genomes[rep], genomes[i]) for i, rep in missing_pairs]
        )
        for (i, rep), ani in zip(missing_pairs, anis):
            calculated.insert((i, rep), ani)

    for i in range(len(genomes)):
        if i in rep_set:
            continue
        best_rep = None
        best_ani = None
        for rep in adj[i]:
            if rep not in rep_set:
                continue
            got = calculated.get((i, rep))
            ani = got[0] if got is not None else None
            if ani is not None and (best_ani is None or ani > best_ani):
                best_rep = rep
                best_ani = ani
        if best_rep is None:
            raise RuntimeError(
                f"Programming error: genome {genomes[i]} has no ANI to any "
                "representative in its precluster"
            )
        result[rep_to_index[best_rep]].append(i)
    return result


def _adjacency(
    cache: SortedPairDistanceCache, n: int
) -> List[List[int]]:
    """Per-genome sorted neighbor lists from cache key presence."""
    adj: List[List[int]] = [[] for _ in range(n)]
    for (i, j), _ in cache.items():
        adj[i].append(j)
        adj[j].append(i)
    for lst in adj:
        lst.sort()
    return adj


def _insort(sorted_list: List[int], value: int) -> None:
    import bisect

    bisect.insort(sorted_list, value)


def _clone_cache(cache: SortedPairDistanceCache) -> SortedPairDistanceCache:
    out = SortedPairDistanceCache()
    for k, v in cache.items():
        out.insert(k, v)
    return out
