"""Signature-parity audit: reference public API vs nessai_tpu.

Walks ``/root/reference/src/nessai`` with ``ast``, collects every public
function/method signature (module, qualname, parameter names), does the
same for ``nessai_tpu``, and reports reference callables whose name has
no counterpart in the repo, plus matched callables whose keyword
parameters are missing.

This is an audit aid, not a gate: nessai_tpu is a redesign, so some
internal helpers legitimately have no counterpart. The point is to make
the *deliberate* divergences visible so they can be documented in the
migration guide.

Usage: python tools/api_audit.py [--all]
  default: only report reference *public* names (no leading underscore)
  --all:   include private names too
"""

import ast
import os
import sys
from collections import defaultdict

REF = "/root/reference/src/nessai"
REPO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "nessai_tpu")

#: Known, documented divergences (docs/migrating-from-nessai.md,
#: "Known API divergences"). Names here are torch-facing surfaces that
#: deliberately became config keys / pure functions in the JAX build.
EXPLAINED_NAMES = {
    "create_net": "torch-module factory hook; use flow config / register_flow",
    "create_resnet": "torch-module factory hook; use flow config",
    "spline_constructor": "torch-module factory hook; use flow config",
    "last_updated": "plain attribute (training bookkeeping), not a property",
    "optimiser": "optax state lives inside the jitted train step",
    "set_torch_default_dtype": "dtype set via config.compute.dtype",
    "to": "torch device move; JAX device placement is automatic",
    "training_config": "plain attribute, not a property",
}
EXPLAINED_PARAM_SITES = {
    # torch-module constructors whose kwargs moved into the flow config
    "flows/base.py:NFlow.__init__",
    "flows/realnvp.py:RealNVP.__init__",
    "flows/maf.py:MaskedAutoregressiveFlow.__init__",
    "flows/nets.py:MLP.__init__",
    "flows/nsf.py:NeuralSplineFlow.__init__",
    "experimental/flows/glasflow.py:GlasflowWrapper.__init__",
    # pure-function equivalents: array-first argument names differ
    "flows/nets.py:MLP.forward",
    "flows/base.py:NFlow.log_prob",
    "flows/base.py:NFlow.sample",
    "flowmodel/base.py:FlowModel.loss_fn",
    "flows/utils.py:reset_permutations",
    "flows/utils.py:reset_weights",
    "experimental/flowmodel/clustering.py:ClusteringFlowModel.sample",
    "experimental/flowmodel/clustering.py:silhouette_score",
    "flowmodel/utils.py:update_config",
    "flowmodel/utils.py:update_flow_config",
    "flowmodel/utils.py:update_training_config",
    "stopping_criteria.py:StoppingCriterionRegistry.decorator",
}


def collect(root):
    """{name: [(module, qualname, [params...])]} for every def in *root*."""
    out = defaultdict(list)
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            mod = os.path.relpath(path, root)
            try:
                tree = ast.parse(open(path).read())
            except SyntaxError:
                continue

            class V(ast.NodeVisitor):
                def __init__(self):
                    self.stack = []

                def visit_ClassDef(self, node):
                    self.stack.append(node.name)
                    self.generic_visit(node)
                    self.stack.pop()

                def _fn(self, node):
                    qual = ".".join(self.stack + [node.name])
                    a = node.args
                    params = (
                        [p.arg for p in a.posonlyargs]
                        + [p.arg for p in a.args]
                        + ([a.vararg.arg] if a.vararg else [])
                        + [p.arg for p in a.kwonlyargs]
                        + ([a.kwarg.arg] if a.kwarg else [])
                    )
                    out[node.name].append((mod, qual, params))
                    self.generic_visit(node)

                visit_FunctionDef = _fn
                visit_AsyncFunctionDef = _fn

            V().visit(tree)
    return out


def main():
    include_private = "--all" in sys.argv
    ref = collect(REF)
    repo = collect(REPO)

    missing_names = []
    missing_params = []
    for name, sites in sorted(ref.items()):
        if not include_private and name.startswith("_") and name != "__init__":
            continue
        if name not in repo:
            missing_names.append((name, sites))
            continue
        repo_params = set()
        for _m, _q, ps in repo[name]:
            repo_params.update(ps)
        for mod, qual, ps in sites:
            gone = [
                p
                for p in ps
                if p not in repo_params
                and not p.startswith("_")
                and p not in ("self", "cls", "args", "kwargs", "kwds")
            ]
            if gone:
                missing_params.append((name, mod, qual, gone))

    print(f"reference callables: {sum(len(v) for v in ref.values())}")
    print(f"repo callables:      {sum(len(v) for v in repo.values())}")
    unexplained_names = [
        (n, s) for n, s in missing_names if n not in EXPLAINED_NAMES
    ]
    explained_names = [
        (n, s) for n, s in missing_names if n in EXPLAINED_NAMES
    ]
    unexplained_params = [
        t for t in missing_params if f"{t[1]}:{t[2]}" not in EXPLAINED_PARAM_SITES
    ]
    explained_params = [
        t for t in missing_params if f"{t[1]}:{t[2]}" in EXPLAINED_PARAM_SITES
    ]
    print(
        f"\n== reference names with NO repo counterpart "
        f"({len(missing_names)}; {len(unexplained_names)} unexplained) =="
    )
    for name, sites in unexplained_names:
        locs = ", ".join(f"{m}:{q}" for m, q, _ in sites[:3])
        print(f"  UNEXPLAINED {name}  [{locs}]")
    for name, sites in explained_names:
        locs = ", ".join(f"{m}:{q}" for m, q, _ in sites[:3])
        print(f"  documented: {name}  [{locs}] — {EXPLAINED_NAMES[name]}")
    print(
        f"\n== matched names with missing keyword params "
        f"({len(missing_params)}; {len(unexplained_params)} unexplained) =="
    )
    for name, mod, qual, gone in unexplained_params:
        print(f"  UNEXPLAINED {mod}:{qual}  missing {gone}")
    for name, mod, qual, gone in explained_params:
        print(f"  documented: {mod}:{qual}  missing {gone}")
    n_unexplained = len(unexplained_names) + len(unexplained_params)
    print(
        f"\n{n_unexplained} unexplained divergence(s); the documented "
        "ones are listed in docs/migrating-from-nessai.md "
        '("Known API divergences").'
    )
    return n_unexplained


if __name__ == "__main__":
    main()
