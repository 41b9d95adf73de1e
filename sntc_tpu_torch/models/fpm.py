"""FPGrowth: frequent-itemset mining and association rules.

Counterpart of ``sntc_tpu/models/fpm.py`` (Spark's ``FPGrowth``):
``itemsCol`` (arrays of items), ``minSupport`` (0.3) filters itemsets by
their share of the rows, ``minConfidence`` (0.8) filters the association
rules; the model's ``freqItemsets`` (items, freq), ``associationRules``
(antecedent, consequent, confidence, lift, support; one-item
consequents, Spark's rule shape) and ``transform`` (each row's predicted
consequents: rules whose antecedent lies in the basket and whose
consequent does not).

The FP-tree recursion (Han et al.) on the host, as in the JAX package:
mining is pointer-chasing over a prefix tree, with no dense numeric work
for a device.  Every itemset above ``minSupport`` is mined, so the
output is Spark's whatever the algorithm.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from itertools import chain, repeat
from typing import Dict, List, Tuple

import numpy as np

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, object_column
from sntc_tpu_torch.core.params import Param, validators


class _FPNode:
    __slots__ = ("item", "count", "parent", "children")

    def __init__(self, item, parent):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: Dict = {}


def _build_tree(baskets: List[Tuple[Tuple, int]], min_count: float):
    """FP-tree over (basket, multiplicity) pairs; returns (root, header
    links item -> [nodes]) after frequency-ordering and pruning."""
    counts: Dict = Counter()
    for items, mult in baskets:
        if mult == 1:
            counts.update(items)
        else:
            for it in items:
                counts[it] += mult
    freq = {it: c for it, c in counts.items() if c >= min_count}
    order = {
        it: i
        for i, it in enumerate(
            sorted(freq, key=lambda it: (-freq[it], str(it)))
        )
    }
    root = _FPNode(None, None)
    header: Dict = defaultdict(list)
    for items, mult in baskets:
        path = sorted(order.keys() & items, key=order.__getitem__)
        node = root
        for it in path:
            child = node.children.get(it)
            if child is None:
                child = _FPNode(it, node)
                node.children[it] = child
                header[it].append(child)
            child.count += mult
            node = child
    return root, header, freq, order


def _mine(baskets, min_count, suffix, out):
    """Recursive FP-growth: emit every frequent itemset extending
    ``suffix``."""
    _, header, freq, order = _build_tree(baskets, min_count)
    # least-frequent first (bottom of the order) — the classic traversal
    for it in sorted(order, key=order.__getitem__, reverse=True):
        support = freq[it]
        itemset = (it,) + suffix
        out[tuple(sorted(itemset, key=str))] = support
        # conditional pattern base: prefix paths of every `it` node
        cond: List[Tuple[Tuple, int]] = []
        for node in header[it]:
            path = []
            p = node.parent
            while p is not None and p.item is not None:
                path.append(p.item)
                p = p.parent
            if path:
                cond.append((tuple(path), node.count))
        if cond:
            _mine(cond, min_count, itemset, out)


class _FpParams:
    itemsCol = Param("basket column (arrays of items)", default="items")
    predictionCol = Param("output consequents column", default="prediction")
    minSupport = Param("min itemset frequency (fraction of rows)",
                       default=0.3, validator=validators.in_range(0, 1))
    minConfidence = Param("min rule confidence", default=0.8,
                          validator=validators.in_range(0, 1))


class FPGrowth(_FpParams, Estimator):
    def _fit(self, frame: Frame) -> "FPGrowthModel":
        # numpy scalars → native Python (keys must JSON-round-trip with
        # their types intact: int 1 and str "1" are different items)
        col = frame[self.getItemsCol()]
        if any(hasattr(t, "item")
               for t in set(map(type, chain.from_iterable(col)))):
            rows = [tuple(x.item() if hasattr(x, "item") else x for x in v)
                    for v in col]
        else:
            rows = [tuple(v) for v in col]
        for r in rows:
            if len(set(r)) != len(r):
                raise ValueError(
                    "baskets must not contain duplicate items (Spark "
                    "raises SparkException on non-unique transactions)"
                )
        n = len(rows)
        min_count = float(self.getMinSupport()) * n
        out: Dict[Tuple, int] = {}
        _mine([(r, 1) for r in rows], max(min_count, 1e-12), (), out)
        model = FPGrowthModel(itemsets=out, numRows=n)
        model.setParams(**self.paramValues())
        return model


class FPGrowthModel(_FpParams, Model):
    def __init__(self, itemsets: Dict[Tuple, int], numRows: int, **kwargs):
        super().__init__(**kwargs)
        self._itemsets = dict(itemsets)
        self.numRows = int(numRows)
        self._rules = None
        self._rules_conf = None  # minConfidence the cache was built at

    @property
    def freqItemsets(self) -> Frame:
        keys = sorted(self._itemsets, key=lambda t: (len(t), [str(x) for x in t]))
        return Frame({
            "items": object_column([list(k) for k in keys]),
            "freq": np.array([self._itemsets[k] for k in keys], np.int64),
        })

    @property
    def associationRules(self) -> Frame:
        """Single-item-consequent rules above ``minConfidence`` [U], with
        confidence, lift and support."""
        min_conf = float(self.getMinConfidence())
        if self._rules is None or self._rules_conf != min_conf:
            self._rules_conf = min_conf
            ante, cons, confs, lifts, sups = [], [], [], [], []
            for itemset, freq in self._itemsets.items():
                if len(itemset) < 2:
                    continue
                for i, c in enumerate(itemset):
                    a = itemset[:i] + itemset[i + 1:]
                    fa = self._itemsets.get(a)
                    fc = self._itemsets.get((c,))
                    if not fa or not fc:
                        continue
                    conf = freq / fa
                    if conf >= min_conf:
                        ante.append(list(a))
                        cons.append([c])
                        confs.append(conf)
                        lifts.append(conf / (fc / self.numRows))
                        sups.append(freq / self.numRows)
            self._rules = (ante, cons, confs, lifts, sups)
        ante, cons, confs, lifts, sups = self._rules
        return Frame({
            "antecedent": object_column(ante),
            "consequent": object_column(cons),
            "confidence": np.array(confs, np.float64),
            "lift": np.array(lifts, np.float64),
            "support": np.array(sups, np.float64),
        })

    def transform(self, frame: Frame) -> Frame:
        """Each basket's consequents, in rule order without repeats, of
        the rules whose antecedent the basket holds and whose consequent
        it does not: every rule against every basket as one membership
        product over the rules' items."""
        rules = self.associationRules
        ante = [list(a) for a in rules["antecedent"]]
        cons = [c[0] for c in rules["consequent"]]
        baskets = [list(b) for b in frame[self.getItemsCol()]]
        n = len(baskets)
        out = [[] for _ in range(n)]
        if cons and n:
            items: dict = {}
            for a, c in zip(ante, cons):
                for it in (*a, c):
                    items.setdefault(it, len(items))
            lens = np.fromiter(map(len, baskets), np.int64, count=n)
            rows = np.repeat(np.arange(n), lens)
            cols = np.fromiter(map(items.get, chain.from_iterable(baskets),
                                   repeat(-1)), np.int64,
                               count=int(lens.sum()))
            have = np.zeros((n, len(items)), np.int32)
            have[rows[cols >= 0], cols[cols >= 0]] = 1
            need = np.zeros((len(cons), len(items)), np.int32)
            for r, a in enumerate(ante):
                need[r, [items[x] for x in a]] = 1
            fires = (have @ need.T) == need.sum(axis=1)
            fires &= have[:, [items[c] for c in cons]] == 0
            # each consequent's first firing rule orders a row's list
            kinds: dict = {}
            kind = np.array([kinds.setdefault(c, len(kinds)) for c in cons])
            first = np.full((n, len(kinds)), len(cons))
            for k in range(len(kinds)):
                rules_k = np.flatnonzero(kind == k)
                f = fires[:, rules_k]
                hit = f.any(axis=1)
                first[hit, k] = rules_k[f[hit].argmax(axis=1)]
            order = np.argsort(first, axis=1, kind="stable")
            count = (first < len(cons)).sum(axis=1)
            named = np.empty(len(kinds), dtype=object)
            for c, k in kinds.items():
                named[k] = c
            for i in np.flatnonzero(count):
                out[i] = list(named[order[i, :count[i]]])
        return frame.with_column(self.getPredictionCol(), object_column(out))

    def _save_extra(self):
        keys = list(self._itemsets)
        return (
            {
                "numRows": self.numRows,
                # items stored with native types (JSON keeps int vs str
                # distinct) — stringifying here would silently retype
                # integer baskets on load
                "itemsets": [
                    {"items": list(k), "freq": self._itemsets[k]}
                    for k in keys
                ],
            },
            {},
        )

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        itemsets = {
            tuple(rec["items"]): int(rec["freq"])
            for rec in extra["itemsets"]
        }
        m = cls(itemsets=itemsets, numRows=int(extra["numRows"]))
        m.setParams(**params)
        return m
