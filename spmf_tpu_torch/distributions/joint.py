"""Named joint distributions with DAG dependencies (mirrors
spmf_tpu/distributions/joint.py): dict values are Distribution objects or
callables whose argument names refer to other entries of the dict."""
from __future__ import annotations

import inspect

__all__ = ["JointDistributionNamed"]


class JointDistributionNamed:
    def __init__(self, model: dict):
        self.model = dict(model)
        self._deps = {}
        for name, node in self.model.items():
            if callable(node) and not hasattr(node, "log_prob"):
                self._deps[name] = tuple(
                    inspect.signature(node).parameters.keys()
                )
            else:
                self._deps[name] = ()
        self._order = self._toposort()

    def _toposort(self):
        """The names with every node after the nodes it depends on."""
        order, seen = [], set()

        def visit(name, stack=()):
            if name in seen:
                return
            if name in stack:
                raise ValueError(f"Cycle in joint distribution at {name!r}")
            for dep in self._deps[name]:
                if dep in self.model:
                    visit(dep, stack + (name,))
            seen.add(name)
            order.append(name)

        for name in self.model:
            visit(name)
        return order

    @property
    def names(self):
        return list(self.model.keys())

    def _resolve(self, name, values):
        node = self.model[name]
        if callable(node) and not hasattr(node, "log_prob"):
            return node(**{dep: values[dep] for dep in self._deps[name]})
        return node

    def log_prob_parts(self, values: dict) -> dict:
        """Per-variable log-probs given a full assignment."""
        return {
            name: self._resolve(name, values).log_prob(values[name])
            for name in self.model
        }

    def log_prob(self, values: dict):
        out = 0.0
        for v in self.log_prob_parts(values).values():
            out = out + v
        return out

    def sample(self, generator, sample_shape=()) -> dict:
        """One draw of every variable in topological order from
        ``generator``. Only root nodes take ``sample_shape``: a dependent
        node inherits the sample dims through its parents' values (the
        tfd.JointDistributionNamed semantics)."""
        values = {}
        for name in self._order:
            dist = self._resolve(name, values)
            has_model_deps = any(d in self.model for d in self._deps[name])
            values[name] = dist.sample(
                generator, () if has_model_deps else sample_shape)
        return values
