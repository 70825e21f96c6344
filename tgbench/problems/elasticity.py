"""The port's elasticity class: ``ElasticityProblem`` (isotropic, ``E`` and
``nu``, clamped on the whole boundary); a solve's input is a constant body
force."""


def build(mesh, problem: dict, device):
    from repro_torch.fem import ElasticityProblem

    return ElasticityProblem(mesh, e_mod=problem["E"], nu=problem["nu"], device=device)


def solve(port, problem: dict, x, spec, call: dict):
    """``SolveResult`` of one solve on input ``x``."""
    kw = {k: v for k, v in call.items() if k in ("backend", "store")}
    return port.solve(body_force=x, spec=spec, **kw)
