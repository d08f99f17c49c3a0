"""A* search over the edit graph, in plain and diagonal-transition flavors.

Host-side re-implementation of the reference's A* runtime
(`astarpa/src/astar.rs:35-301`, `astar_dt.rs:34-338`): a bucket priority
queue keyed by f = g + h, hint-accelerated heuristic evaluation, lazy
re-ordering of stale entries (h only grows under pruning, so a popped state
whose f is outdated is re-pushed instead of expanded), greedy diagonal
extension inside seeds, match pruning on expanded seed starts/ends with O(1)
queue shifts, and traceback via parent scanning.

This is deliberately a *runtime* component, not a kernel: the A* loop is
data-dependent pointer chasing, which is the part of the reference that does
not map to batched device kernels.  Their equivalent of A*PA is the block
band-doubling aligner (:mod:`astarpa_tpu.aligners.astarpa2`) which computes
the same exact answer; this module exists for full API/behavior parity and
as the differential-testing anchor.  A C++ native version of this loop lives
in :mod:`astarpa_tpu.native` for production use.
"""

from __future__ import annotations

from ..types import Cigar, Pos
from .graph import Edge, EditGraph, dt_fr, dt_key, dt_to_pos
from .queue import ShiftQueue
from .stats import AstarStats, PhaseTimer


def _zero_order(h) -> object:
    """The identity element for the heuristic's shift order."""
    o = getattr(h, "order_zero", None)
    return o() if callable(o) else 0


def astar(a: bytes, b: bytes, h_factory, v=None):
    """Align ``a`` and ``b`` with A* over `Pos` states (`astar.rs:35-261`).

    Returns ``((cost, Cigar), AstarStats)``.
    """
    stats = AstarStats.init(a, b)
    timer = PhaseTimer()

    graph = EditGraph(a, b, greedy_matching=True)
    h = h_factory.build(a, b)
    stats.timing.precomp = timer.lap()
    vi = v.build(a, b) if v is not None else None

    queue = ShiftQueue(h.root_potential(), _zero_order(h))
    # Pos -> [g, hint]
    states: dict[Pos, list] = {}

    start = Pos(0, 0)
    hroot, hint = h.h_with_hint(start, h.default_hint())
    queue.push(hroot, (start, 0), _order(h, start))
    states[start] = [0, hint]
    stats.explored += 1
    stats.h.h0 = hroot
    if vi is not None:
        vi.new_layer(h)
    max_f = 0

    target = graph.target
    while True:
        e = queue.pop()
        assert e is not None, "priority queue is empty before the end is reached."
        queue_f, (pos, queue_g) = e

        state = states.get(pos)
        if state is None or queue_g > state[0]:
            continue
        assert queue_g == state[0]

        # Re-evaluate h on pop; pruning may have outdated the stored f, in
        # which case the element is re-pushed, not expanded
        # (`astar.rs:109-134`).
        current_h, state[1] = h.h_with_hint(pos, state[1])
        current_f = state[0] + current_h
        assert current_f >= queue_f, (
            f"Retry {pos}: current_f {current_f} < queue_f {queue_f}"
        )
        if current_f > queue_f:
            stats.reordered += 1
            queue.push(current_f, (pos, queue_g), _order(h, pos))
            continue

        stats.expanded += 1
        if vi is not None:
            vi.expand(pos, queue_g, queue_f, h)
            if queue_f > max_f:
                max_f = queue_f
                vi.new_layer(h)

        if pos == target:
            break

        g = state[0]
        hint = state[1]

        # Prune matches at expanded seed starts/ends and shift the queue
        # (`astar.rs:169-174`).
        if h.is_seed_start_or_end(pos):
            shift, below = h.prune(pos, hint)
            stats.pq_shifts += 1 if queue.shift(shift, below) else 0

        for next_pos, edge in graph.outgoing_edges(pos):
            next_g = g + edge.cost()

            # Greedy diagonal extension within the seed (`astar.rs:181-204`).
            while True:
                n = graph.is_match(next_pos)
                if n is None or h.is_seed_start_or_end(next_pos):
                    break
                stats.extended += 1
                if vi is not None:
                    vi.extend(next_pos, queue_g, queue_f, h)
                next_pos = n

            cur = states.get(next_pos)
            if cur is not None and cur[0] <= next_g:
                continue

            next_h, next_hint = h.h_with_hint(next_pos, hint)
            if cur is None:
                states[next_pos] = [next_g, next_hint]
            else:
                cur[0] = next_g
                cur[1] = next_hint
            queue.push(next_g + next_h, (next_pos, next_g), _order(h, next_pos))
            h.explore(next_pos)
            stats.explored += 1
            if vi is not None:
                vi.explore(next_pos, next_g, next_g + next_h, h)

    stats.hashmap_size = len(states)
    stats.timing.astar = timer.lap()
    d, path = _traceback(states, target)
    cigar = Cigar.from_path(a, b, path)
    stats.timing.traceback = timer.lap()
    stats.timing.total = (
        stats.timing.precomp + stats.timing.astar + stats.timing.traceback
    )
    stats.distance = d
    stats.pq_shifts = queue.pq_shifts
    _fill_h_stats(stats, h)
    assert stats.h.h0 <= d, f"h(0,0)={stats.h.h0} exceeds the distance {d}"
    if vi is not None:
        vi.last_frame(cigar, h)
    return (d, cigar), stats


def _order(h, pos: Pos):
    to_order = getattr(h, "order_of", None)
    return to_order(pos) if to_order is not None else 0


def _traceback(states: dict, target: Pos):
    """Walk parents by g-difference; unexplained steps are matches
    (`astar.rs:263-301`)."""
    g = states[target][0]
    path = [target]
    cost = 0
    cur = target
    while cur != Pos(0, 0):
        edge = Edge.MATCH
        for e in (Edge.SUB, Edge.RIGHT, Edge.DOWN):
            p = e.back(cur)
            if p is not None:
                s = states.get(p)
                if s is not None and s[0] + e.cost() == g - cost:
                    edge = e
                    break
        cost += edge.cost()
        cur = edge.back(cur)
        assert cur is not None, "No parent found during traceback"
        path.append(cur)
    path.reverse()
    assert cost == g, f"Traceback cost {cost} != distance {g}"
    return g, path


def astar_dt(a: bytes, b: bytes, h_factory, v=None):
    """A* over diagonal-transition states (`astar_dt.rs:34-264`).

    States are keyed ``(diagonal, g)`` holding the farthest-reaching value
    ``fr = i + j``; only strictly farther-reaching pops are expanded.
    """
    stats = AstarStats.init(a, b)
    timer = PhaseTimer()

    graph = EditGraph(a, b, greedy_matching=True)
    h = h_factory.build(a, b)
    stats.timing.precomp = timer.lap()
    vi = v.build(a, b) if v is not None else None

    queue = ShiftQueue(h.root_potential(), _zero_order(h))
    # (diagonal, g) -> [fr, hint]
    states: dict[tuple[int, int], list] = {}

    start = Pos(0, 0)
    hroot, hint = h.h_with_hint(start, h.default_hint())
    queue.push(hroot, (start, 0), _order(h, start))
    states[dt_key(start, 0)] = [0, hint]
    stats.explored += 1
    stats.h.h0 = hroot
    if vi is not None:
        vi.new_layer(h)
    max_f = 0

    target = graph.target
    while True:
        e = queue.pop()
        assert e is not None, "priority queue is empty before the end is reached."
        queue_f, (pos, queue_g) = e
        key = dt_key(pos, queue_g)
        queue_fr = dt_fr(pos)

        state = states[key]
        if queue_fr < state[0]:
            continue
        assert queue_fr == state[0], f"Bad FR in queue at {pos}"

        current_h, state[1] = h.h_with_hint(pos, state[1])
        current_f = queue_g + current_h
        assert current_f >= queue_f, (
            f"Retry {pos}: current_f {current_f} < queue_f {queue_f}"
        )
        if current_f > queue_f:
            stats.reordered += 1
            queue.push(current_f, (pos, queue_g), _order(h, pos))
            continue

        stats.expanded += 1
        if vi is not None:
            vi.expand(pos, queue_g, queue_f, h)
            if queue_f > max_f:
                max_f = queue_f
                vi.new_layer(h)

        if pos == target:
            dist = queue_g
            break

        hint = state[1]
        if h.is_seed_start_or_end(pos):
            shift, below = h.prune(pos, hint)
            stats.pq_shifts += 1 if queue.shift(shift, below) else 0

        for next_pos, edge in graph.outgoing_edges(pos):
            next_g = queue_g + edge.cost()
            next_key = dt_key(next_pos, next_g)
            cur = states.get(next_key)

            # A farther-reaching state on this diagonal subsumes this one
            # (`astar_dt.rs:184-186`).
            if cur is not None and cur[0] >= dt_fr(next_pos):
                continue

            while True:
                n = graph.is_match(next_pos)
                if n is None or h.is_seed_start_or_end(next_pos):
                    break
                stats.extended += 1
                if vi is not None:
                    vi.extend(next_pos, queue_g, queue_f, h)
                next_pos = n

            next_fr = dt_fr(next_pos)
            next_h, next_hint = h.h_with_hint(next_pos, hint)
            if cur is None:
                states[next_key] = [next_fr, next_hint]
            else:
                cur[0] = next_fr
                cur[1] = next_hint
            queue.push(next_g + next_h, (next_pos, next_g), _order(h, next_pos))
            h.explore(next_pos)
            stats.explored += 1
            if vi is not None:
                vi.explore(next_pos, next_g, next_g + next_h, h)

    stats.hashmap_size = len(states)
    stats.timing.astar = timer.lap()
    d, path = _traceback_dt(states, target, dist)
    cigar = Cigar.from_path(a, b, path)
    stats.timing.traceback = timer.lap()
    stats.timing.total = (
        stats.timing.precomp + stats.timing.astar + stats.timing.traceback
    )
    stats.distance = d
    stats.pq_shifts = queue.pq_shifts
    _fill_h_stats(stats, h)
    assert stats.h.h0 <= d, f"h(0,0)={stats.h.h0} exceeds the distance {d}"
    if vi is not None:
        vi.last_frame(cigar, h)
    return (d, cigar), stats


def _dt_parent(states: dict, diagonal: int, g: int):
    """Farthest-reaching parent among Right/Down/Sub (`astar_dt.rs:267-281`)."""
    best_fr, best_edge = 0, Edge.NONE
    for edge in (Edge.RIGHT, Edge.DOWN, Edge.SUB):
        p = edge.dt_back(diagonal, g)
        if p is None:
            continue
        s = states.get(p)
        if s is not None and s[0] + edge.to_f() >= best_fr + best_edge.to_f():
            best_fr, best_edge = s[0], edge
    return best_fr, best_edge


def _traceback_dt(states: dict, target: Pos, g: int):
    """Ukkonen'85-style traceback re-inserting match runs
    (`astar_dt.rs:283-338`)."""
    cost = 0
    cost_from_start = g
    cur_pos = target
    path = [cur_pos]
    cur_dt = dt_key(target, g)
    while cur_dt != (0, 0):
        parent_fr, edge = _dt_parent(states, cur_dt[0], cur_dt[1])
        cost += edge.cost()
        next_dt = edge.dt_back(cur_dt[0], cur_dt[1])
        assert next_dt is not None, "No parent found during DT traceback"
        next_pos = dt_to_pos(next_dt[0], parent_fr)
        # Insert matches until the edge lands exactly on next_pos; strict >
        # since next_pos can overshoot (`astar_dt.rs:305-315`).
        while _gt(edge.back(cur_pos), next_pos):
            cur_pos = Edge.MATCH.back(cur_pos)
            path.append(cur_pos)
        cur_pos = edge.back(cur_pos)
        cost_from_start -= edge.cost()
        path.append(cur_pos)
        cur_dt = next_dt
    while cur_pos != Pos(0, 0):
        cur_pos = Edge.MATCH.back(cur_pos)
        path.append(cur_pos)
    path.reverse()
    assert cost == g, f"Traceback cost {cost} != distance {g}"
    assert cost_from_start == 0
    return g, path


def _gt(p: Pos, q: Pos) -> bool:
    """The reference's `Pos` partial order: p > q iff both components >=
    and at least one > (total on a diagonal walk)."""
    return p.i >= q.i and p.j >= q.j and (p.i > q.i or p.j > q.j)


def _fill_h_stats(stats: AstarStats, h) -> None:
    h0 = stats.h.h0
    hs = getattr(h, "stats", None)
    if callable(hs):
        stats.h = hs()
        stats.h.h0 = h0
