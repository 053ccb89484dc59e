"""GO-term pan-category profiles.

Behavioral contract: reference scripts/pan_goterm.py:
- go.obo parsed into [Term] stanzas; obsolete terms skipped; is_a edges
  build a DiGraph with parentless terms attached to 'root' (:83-96);
- a term's level-2 ancestor = element [2] of the shortest path from root
  (golv, :102-112), 'unknown' when unreachable;
- input annotations: rows whose first column is a gene id and which
  contain GO:ddddddd ids anywhere (e.g. interproscan output); (gene, go)
  pairs deduplicated;
- output: crosstab of (namespace, level-2 term name) x pan category.

No download here (zero-egress environment): go.obo must be a local path.

Copied from ``swiftortho_tpu/analysis/goterm.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Iterator, Tuple

_GO = re.compile(r'GO:\d{7}')


def oboparse(lines: Iterable[str]) -> Iterator[dict]:
    node: dict = {}
    for line in lines:
        flag = line.strip()
        if flag.startswith('['):
            if node.get('stanza') == '[Term]':
                yield node
            node = {'stanza': flag}
        else:
            parts = line.split(':', 1)
            if len(parts) != 2:
                continue
            node.setdefault(parts[0], []).append(parts[1])
    if node.get('stanza') == '[Term]':
        yield node


class GoDag:
    def __init__(self, obo_lines: Iterable[str]):
        import networkx as nx
        self.graph = nx.DiGraph()
        self.tables: Dict[str, dict] = {}
        for term in oboparse(obo_lines):
            if 'is_obsolete' in term:
                continue
            m = _GO.findall(term['id'][0])
            if not m:
                continue
            goid = m[0]
            self.graph.add_node(goid)
            self.tables[goid] = term
            is_as = [(p, goid) for e in term.get('is_a', [])
                     for p in _GO.findall(e)[:1]]
            if is_as:
                self.graph.add_edges_from(is_as)
            else:
                self.graph.add_edge('root', goid)

    def level(self, goid: str, level: int = 2) -> str:
        import networkx as nx
        level = max(level, 1)
        try:
            path = nx.shortest_path(self.graph, 'root', goid)
            return path[level]
        except Exception:
            return 'unknown'

    def describe(self, goid: str) -> Tuple[str, str]:
        t = self.tables.get(goid, {})
        ns = t.get('namespace', [' unknown'])[0].strip()
        name = t.get('name', [' unknown'])[0].strip()
        return ns, name


def goterm_profile(annot_lines: Iterable[str], type_of: Dict[str, str],
                   dag: GoDag, default: str | None = None) -> Iterator[str]:
    """Crosstab rows: 'GOterm\\tfunction\\t<count per pan type>'."""
    if default is None:
        default = getattr(type_of, 'default_type', 'unknown')
    outputs: Dict[Tuple[str, str], Dict[str, int]] = {}
    all_types = set()
    visit = set()
    for line in annot_lines:
        goids = _GO.findall(line)
        qid = line.rstrip('\n').split('\t')[0]
        gtype = type_of.get(qid, default)
        all_types.add(gtype)
        for goid in goids:
            if (qid, goid) in visit:
                continue
            visit.add((qid, goid))
            sid = dag.level(goid, 2)
            if sid == 'unknown':
                continue
            key = dag.describe(sid)
            outputs.setdefault(key, {})
            outputs[key][gtype] = outputs[key].get(gtype, 0) + 1

    types = sorted(all_types)
    yield '\t'.join(['GOterm', 'function'] + types) + '\n'
    for key in sorted(outputs):
        counts = [str(outputs[key].get(t, 0)) for t in types]
        yield '\t'.join(key) + '\t' + '\t'.join(counts) + '\n'


class TypeMap(dict):
    """gene -> pan type; `default_type` covers genes absent from the
    .clsr (pan_genome's trailing singleton rows name no genes, so their
    members cannot appear in the map — they are 'Specific' by
    construction, reference pan_genome.py:169)."""

    default_type = 'unknown'


def pan_type_map(pan_lines: Iterable[str],
                 clsr_lines: Iterable[str]) -> Dict[str, str]:
    """gene -> pan category, joining the .pan table with the .clsr rows.

    .pan group rows are emitted in .clsr line order, followed by one
    singleton row per unclustered gene (build_matrix). Rows past
    len(clsr) are those singletons; their type becomes default_type for
    genes the map cannot name.
    """
    types = []
    for line in pan_lines:
        if line.startswith('#'):
            continue
        f = line.rstrip('\n').split('\t', 2)
        if len(f) >= 2 and f[0].startswith('group_'):
            types.append(f[1])
    out = TypeMap()
    n = 0
    for typ, row in zip(types, clsr_lines):
        n += 1
        for g in row.rstrip('\n').split('\t'):
            out[g] = typ
    if len(types) > n:   # trailing singleton rows (all 'Specific')
        out.default_type = types[n]
    return out
