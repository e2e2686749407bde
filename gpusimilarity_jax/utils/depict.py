"""Dependency-free 2-D molecule depiction (SVG).

The reference debug UI renders every query/result structure as an RDKit PNG
cached in a tempdir (``gpusim_server.py:171-252``, ``gpusim_utils.py:69-71``).
This rebuild serves inline SVG instead — no image files, no cache dir, no
filename escaping — produced by RDKit's SVG drawer when RDKit is importable
and otherwise by this module: a small structure-diagram generator over the
built-in SMILES parser's molecular graph (``utils/smiles.py``).

Layout algorithm (classic simplified SDG):

* rings are found per ring-bond by shortest-cycle search and reduced to an
  SSSR-like basis; each fused ring system is laid out ring-by-ring as
  regular polygons sharing edges (reflected away from the already-placed
  ring) or spiro atoms;
* acyclic atoms grow breadth-first from placed atoms, each new bond placed
  in the middle of the largest angular gap at its anchor (zigzag falls out
  of the two-bond case);
* coordinates are fit to the viewport; heteroatoms (and charged/isotopic
  atoms) get text labels with implicit-H counts, carbons stay bare;
  double/triple bonds draw parallel lines and aromatic rings an inner
  circle.

Bridged polycyclics and macrocycles come out readable but not pretty —
this is a debug-UI renderer, not a publication tool.
"""

from __future__ import annotations

import html
import math
from collections import deque

from .smiles import Molecule, SmilesError, parse_smiles

BOND_LEN = 1.0


# ------------------------------------------------------------------ rings


def find_rings(mol: Molecule) -> list[list[int]]:
    """SSSR-like ring basis: for every ring bond, the shortest cycle through
    it; deduplicated, smallest first, keeping rings that cover a new bond."""
    cycles: dict[frozenset, list[int]] = {}
    for bi, bond in enumerate(mol.bonds):
        if not getattr(bond, "in_ring", False):
            continue
        path = _shortest_path(mol, bond.a1, bond.a2, skip_bond=bi)
        if path is None:
            continue
        key = frozenset(path)
        if key not in cycles:
            cycles[key] = path
    rings = sorted(cycles.values(), key=len)
    kept: list[list[int]] = []
    covered: set[tuple[int, int]] = set()
    for ring in rings:
        edges = {
            tuple(sorted((ring[i], ring[(i + 1) % len(ring)])))
            for i in range(len(ring))
        }
        if edges - covered:
            kept.append(ring)
            covered |= edges
    return kept


def _shortest_path(mol, src, dst, skip_bond):
    prev = {src: None}
    q = deque([src])
    while q:
        v = q.popleft()
        if v == dst:
            path = []
            while v is not None:
                path.append(v)
                v = prev[v]
            return path
        for bi in mol.neighbors(v):
            if bi == skip_bond:
                continue
            u = mol.bonds[bi].other(v)
            if u not in prev:
                prev[u] = v
                q.append(u)
    return None


# ----------------------------------------------------------------- layout


def layout(mol: Molecule) -> list[tuple[float, float]]:
    """Assign 2-D coordinates to every atom (bond length ~= BOND_LEN)."""
    n = len(mol.atoms)
    pos: list[tuple[float, float] | None] = [None] * n
    if n == 0:
        return []
    rings = find_rings(mol)

    # ring systems: connected components over shared atoms
    systems: list[list[list[int]]] = []
    assigned = [False] * len(rings)
    for i in range(len(rings)):
        if assigned[i]:
            continue
        group, queue = [], [i]
        assigned[i] = True
        while queue:
            ri = queue.pop()
            group.append(rings[ri])
            for rj in range(len(rings)):
                if not assigned[rj] and set(rings[ri]) & set(rings[rj]):
                    assigned[rj] = True
                    queue.append(rj)
        systems.append(group)

    placed_systems = set()

    def place_ring_system(group, anchor=None, direction=(1.0, 0.0)):
        """Lay the group's rings out one by one; returns its atom set."""
        first = group[0]
        _place_polygon(pos, first, center=None, anchor=anchor,
                       direction=direction)
        remaining = list(group[1:])
        guard = len(remaining) * len(remaining) + 1
        while remaining and guard:
            guard -= 1
            for idx, ring in enumerate(remaining):
                shared = [a for a in ring if pos[a] is not None]
                if len(shared) >= 2:
                    _place_fused(pos, ring)
                    remaining.pop(idx)
                    break
                if len(shared) == 1:
                    _place_spiro(mol, pos, ring, shared[0])
                    remaining.pop(idx)
                    break
            else:
                # disconnected within group (shouldn't happen): force one
                _place_polygon(pos, remaining.pop(0), center=None)
        return {a for ring in group for a in ring}

    # seed: largest ring system, else atom 0
    if systems:
        biggest = max(systems, key=lambda g: sum(len(r) for r in g))
        place_ring_system(biggest)
        placed_systems.add(id(biggest))
    else:
        pos[0] = (0.0, 0.0)

    # breadth-first growth over the rest
    frontier = deque(i for i in range(n) if pos[i] is not None)
    seen = set(frontier)
    while frontier:
        v = frontier.popleft()
        for bi in mol.neighbors(v):
            u = mol.bonds[bi].other(v)
            if pos[u] is None:
                system = next(
                    (g for g in systems
                     if id(g) not in placed_systems
                     and any(u in r for r in g)),
                    None,
                )
                d = _next_direction(mol, pos, v)
                if system is not None:
                    place_ring_system(system, anchor=(v, u), direction=d)
                    placed_systems.add(id(system))
                else:
                    px, py = pos[v]
                    pos[u] = (px + d[0] * BOND_LEN, py + d[1] * BOND_LEN)
            if u not in seen:
                seen.add(u)
                frontier.append(u)
        if not frontier:  # disconnected component: drop it to the right
            for i in range(n):
                if pos[i] is None:
                    xs = [p[0] for p in pos if p is not None]
                    pos[i] = (max(xs) + 2 * BOND_LEN, 0.0)
                    frontier.append(i)
                    seen.add(i)
                    break
    return [p if p is not None else (0.0, 0.0) for p in pos]


def _ring_radius(k: int) -> float:
    return BOND_LEN / (2 * math.sin(math.pi / k))


def _place_polygon(pos, ring, center, anchor=None, direction=(1.0, 0.0)):
    """Place ``ring`` as a regular polygon. ``anchor=(placed, first)`` hangs
    the polygon off a placed atom so ring ``first`` sits along direction."""
    k = len(ring)
    r = _ring_radius(k)
    if anchor is not None:
        av, first = anchor
        ax, ay = pos[av]
        fx = ax + direction[0] * BOND_LEN
        fy = ay + direction[1] * BOND_LEN
        cx = fx + direction[0] * r
        cy = fy + direction[1] * r
        ring = ring[ring.index(first):] + ring[: ring.index(first)]
        base = math.atan2(fy - cy, fx - cx)
    elif center is None:
        cx = cy = 0.0
        base = math.pi / 2
    else:
        cx, cy = center
        base = math.pi / 2
    for i, a in enumerate(ring):
        ang = base + 2 * math.pi * i / k
        if pos[a] is None:
            pos[a] = (cx + r * math.cos(ang), cy + r * math.sin(ang))


def _place_fused(pos, ring):
    """Place a ring sharing an edge (>=2 placed atoms) with placed rings:
    regular polygon through the shared edge, on the empty side."""
    k = len(ring)
    placed_idx = [i for i, a in enumerate(ring) if pos[a] is not None]
    # find two placed atoms adjacent in the ring (the shared edge)
    edge = None
    for i in placed_idx:
        j = (i + 1) % k
        if pos[ring[j]] is not None:
            edge = (i, j)
            break
    if edge is None:  # spiro-like fallback
        _place_polygon(pos, ring, center=None,
                       anchor=(ring[placed_idx[0]], ring[(placed_idx[0] + 1) % k]))
        return
    i, j = edge
    a, b = ring[i], ring[j]
    ax, ay = pos[a]
    bx, by = pos[b]
    mx, my = (ax + bx) / 2, (ay + by) / 2
    ex, ey = bx - ax, by - ay
    elen = math.hypot(ex, ey) or 1.0
    # perpendicular, pointing away from already-placed neighbors
    px, py = -ey / elen, ex / elen
    others = [pos[q] for q in ring if pos[q] is not None and q not in (a, b)]
    ref = others or [
        p for p in (pos[q] for q in range(len(pos))) if p is not None
    ]
    gx = sum(p[0] for p in ref) / len(ref)
    gy = sum(p[1] for p in ref) / len(ref)
    if (gx - mx) * px + (gy - my) * py > 0:
        px, py = -px, -py
    apo = _ring_radius(k) * math.cos(math.pi / k)
    cx, cy = mx + px * apo, my + py * apo
    # walk the ring from b away from a, placing vertices around the center
    order = ring[j:] + ring[:j]
    if order[1] == a:  # wrong rotation direction: reverse
        order = [order[0]] + order[1:][::-1]
    start = math.atan2(by - cy, bx - cx)
    # signed direction: the first step must move AWAY from a (a is the
    # last vertex of the walk), i.e. start - step must not land on a
    a_ang = math.atan2(ay - cy, ax - cx)
    step = 2 * math.pi / k
    diff = (start - step - a_ang) % (2 * math.pi)
    if min(diff, 2 * math.pi - diff) < 1e-6:
        step = -step
    for t, q in enumerate(order):
        if pos[q] is None:
            ang = start - step * t
            pos[q] = (cx + _ring_radius(k) * math.cos(ang),
                      cy + _ring_radius(k) * math.sin(ang))


def _place_spiro(mol, pos, ring, shared):
    d = _next_direction(mol, pos, shared)
    k = len(ring)
    r = _ring_radius(k)
    sx, sy = pos[shared]
    cx, cy = sx + d[0] * r, sy + d[1] * r
    idx = ring.index(shared)
    order = ring[idx:] + ring[:idx]
    base = math.atan2(sy - cy, sx - cx)
    for t, q in enumerate(order):
        if pos[q] is None:
            ang = base + 2 * math.pi * t / k
            pos[q] = (cx + r * math.cos(ang), cy + r * math.sin(ang))


def _next_direction(mol, pos, v) -> tuple[float, float]:
    """Unit vector into the middle of the largest angular gap at atom v."""
    vx, vy = pos[v]
    angles = sorted(
        math.atan2(pos[u][1] - vy, pos[u][0] - vx)
        for u in mol.neighbor_atoms(v)
        if pos[u] is not None
    )
    if not angles:
        return (math.cos(-math.pi / 6), math.sin(-math.pi / 6))
    if len(angles) == 1:
        # 120-degree zigzag; flip side by x-parity for a natural chain
        side = 1 if math.cos(angles[0]) >= 0 else -1
        ang = angles[0] + side * 2 * math.pi / 3
        return (math.cos(ang), math.sin(ang))
    best_gap, best_ang = -1.0, 0.0
    for i, a0 in enumerate(angles):
        a1 = angles[(i + 1) % len(angles)] + (2 * math.pi if i + 1 == len(angles) else 0)
        if a1 - a0 > best_gap:
            best_gap = a1 - a0
            best_ang = (a0 + a1) / 2
    return (math.cos(best_ang), math.sin(best_ang))


# ------------------------------------------------------------------- SVG


def mol_to_svg(mol: Molecule, size: int = 200) -> str:
    """Render a laid-out molecule as a standalone ``<svg>`` element."""
    coords = layout(mol)
    if not coords:
        return f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}"/>'
    xs = [c[0] for c in coords]
    ys = [c[1] for c in coords]
    margin = 0.18
    w = max(xs) - min(xs) or 1e-6
    h = max(ys) - min(ys) or 1e-6
    scale = (1 - 2 * margin) * size / max(w, h)
    scale = min(scale, size / 4.0)  # single atoms / tiny molecules
    ox = size / 2 - scale * (min(xs) + w / 2)
    oy = size / 2 + scale * (min(ys) + h / 2)

    def xy(i):
        x, y = coords[i]
        return ox + scale * x, oy - scale * y  # flip y for SVG

    rings = find_rings(mol)
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}" viewBox="0 0 {size} {size}" '
        f'font-family="sans-serif" font-size="{max(9, int(scale * 0.55))}px">'
    ]
    labeled = {
        i for i, a in enumerate(mol.atoms)
        if a.symbol != "C" or a.charge or a.isotope or a.explicit_hs is not None
    }

    def trim(x1, y1, x2, y2, t1, t2):
        dx, dy = x2 - x1, y2 - y1
        ln = math.hypot(dx, dy) or 1.0
        return (x1 + dx / ln * t1, y1 + dy / ln * t1,
                x2 - dx / ln * t2, y2 - dy / ln * t2)

    pad = scale * 0.28
    for bond in mol.bonds:
        x1, y1 = xy(bond.a1)
        x2, y2 = xy(bond.a2)
        x1, y1, x2, y2 = trim(
            x1, y1, x2, y2,
            pad if bond.a1 in labeled else 0, pad if bond.a2 in labeled else 0,
        )
        dx, dy = x2 - x1, y2 - y1
        ln = math.hypot(dx, dy) or 1.0
        nx, ny = -dy / ln * scale * 0.12, dx / ln * scale * 0.12
        n_lines = 1 if bond.aromatic else bond.order
        offsets = {1: (0.0,), 2: (-0.5, 0.5), 3: (-1.0, 0.0, 1.0)}[min(n_lines, 3)]
        for o in offsets:
            parts.append(
                f'<line x1="{x1 + nx * o:.1f}" y1="{y1 + ny * o:.1f}" '
                f'x2="{x2 + nx * o:.1f}" y2="{y2 + ny * o:.1f}" '
                f'stroke="#222" stroke-width="1.4"/>'
            )
    # aromatic circles
    for ring in rings:
        bonds_in = []
        rset = set(ring)
        for b in mol.bonds:
            if b.a1 in rset and b.a2 in rset and getattr(b, "in_ring", False):
                bonds_in.append(b)
        if bonds_in and all(b.aromatic for b in bonds_in):
            cx = sum(xy(a)[0] for a in ring) / len(ring)
            cy = sum(xy(a)[1] for a in ring) / len(ring)
            rr = sum(
                math.hypot(xy(a)[0] - cx, xy(a)[1] - cy) for a in ring
            ) / len(ring)
            parts.append(
                f'<circle cx="{cx:.1f}" cy="{cy:.1f}" r="{rr * 0.58:.1f}" '
                f'fill="none" stroke="#222" stroke-width="1.1"/>'
            )
    for i in sorted(labeled):
        a = mol.atoms[i]
        x, y = xy(i)
        label = a.symbol
        hs = a.total_hs
        if hs:
            label += "H" + (str(hs) if hs > 1 else "")
        if a.charge:
            sign = "+" if a.charge > 0 else "-"
            label += (str(abs(a.charge)) if abs(a.charge) > 1 else "") + sign
        color = {"N": "#2144d0", "O": "#d01414", "S": "#b09000",
                 "P": "#c06000", "F": "#10a010", "Cl": "#10a010",
                 "Br": "#903010", "I": "#702090"}.get(a.symbol, "#222")
        parts.append(
            f'<rect x="{x - pad:.1f}" y="{y - pad:.1f}" width="{2 * pad:.1f}" '
            f'height="{2 * pad:.1f}" fill="white"/>'
            f'<text x="{x:.1f}" y="{y:.1f}" fill="{color}" '
            f'text-anchor="middle" dominant-baseline="central">'
            f"{html.escape(label)}</text>"
        )
    parts.append("</svg>")
    return "".join(parts)


def smiles_to_svg(smiles: str, size: int = 200) -> str:
    """SMILES -> inline SVG: RDKit's drawer when available, else the
    built-in layout. Returns an empty-string on unparseable input (the
    debug UI shows the SMILES text regardless)."""
    from .fingerprints import HAVE_RDKIT

    if HAVE_RDKIT:  # pragma: no cover - exercised only where rdkit exists
        try:
            from rdkit import Chem
            from rdkit.Chem.Draw import rdMolDraw2D

            mol = Chem.MolFromSmiles(smiles)
            if mol is None:
                return ""
            d = rdMolDraw2D.MolDraw2DSVG(size, size)
            rdMolDraw2D.PrepareAndDrawMolecule(d, mol)
            d.FinishDrawing()
            svg = d.GetDrawingText()
            return svg[svg.index("<svg"):]
        except Exception:
            return ""
    try:
        return mol_to_svg(parse_smiles(smiles), size=size)
    except SmilesError:
        return ""  # unparseable input: expected, no depiction
    except Exception:  # layout/renderer defect: keep the UI up, but log it
        import logging

        logging.getLogger("gpusimilarity_jax").debug(
            "depiction failed for %r", smiles, exc_info=True
        )
        return ""
