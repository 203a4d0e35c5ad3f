"""The striped slice broadcast planner, who pulls which pieces over DCN:
the port's copy of ``dragonfly2_tpu/scheduler/scheduling/stripe.py``.

For a pod broadcast to an S-host ICI slice, the host of slice rank r
fetches over DCN exactly the pieces with ``piece_num % S == r``, and the
slice's mates fill the rest, cutting a slice's DCN traffic to one copy
of the file.

The plan is a pure function of (slice membership, own identity), so
every host derives disjoint stripes from the same inputs. Members sort by
(tpu_worker_index, host_id, peer_id).
"""

from __future__ import annotations

# A stripe needs at least two hosts to beat the unstriped path; a lone
# host falls back to the plain broadcast (degraded mode: no stripe field
# in its handout).
MIN_STRIPE_PEERS = 2


def member_key(worker_index: int, host_id: str, peer_id: str) -> tuple:
    """Canonical sort key for one slice member."""
    # Unknown worker indexes (-1) sort first as a group and fall back to
    # the id ordering — still deterministic, just not ICI-ring-ordered.
    return (worker_index, host_id, peer_id)


def plan_stripe(members: "list[tuple]", peer_id: str) -> "dict | None":
    """Compute ``peer_id``'s stripe assignment from the slice membership.

    ``members``: (worker_index, host_id, peer_id) tuples for every ALIVE
    broadcast peer of the task on this slice (including ``peer_id``).
    Returns ``{"slice_size": S, "slice_rank": r, "members": [peer ids in
    rank order]}`` or None when striping does not apply (lone host, or
    ``peer_id`` not in the membership).

    Purity contract: same membership set -> same plan on every host; the
    ranks partition piece numbers into S disjoint, exactly-covering
    stripes (``piece % S == rank``).
    """
    ordered = sorted(set(members))
    ids = [m[2] for m in ordered]
    if len(ids) != len(set(ids)):
        # One peer id under two keys would shift every later rank
        # non-deterministically; collapse to first occurrence.
        seen: set[str] = set()
        dedup = []
        for m in ordered:
            if m[2] not in seen:
                seen.add(m[2])
                dedup.append(m)
        ordered = dedup
        ids = [m[2] for m in ordered]
    if len(ordered) < MIN_STRIPE_PEERS or peer_id not in ids:
        return None
    rank = ids.index(peer_id)
    return {"slice_size": len(ordered), "slice_rank": rank, "members": ids}


def in_stripe(piece_num: int, slice_size: int, slice_rank: int) -> bool:
    """Does ``piece_num`` belong to this host's DCN stripe?"""
    if slice_size <= 1:
        return True
    return piece_num % slice_size == slice_rank


def stripe_piece_count(total_pieces: int, slice_size: int,
                       slice_rank: int) -> int:
    """How many of ``total_pieces`` land in this rank's stripe."""
    if slice_size <= 1:
        return total_pieces
    full, rem = divmod(total_pieces, slice_size)
    return full + (1 if slice_rank < rem else 0)
