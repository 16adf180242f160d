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
