"""The port's Poisson class: ``PoissonProblem`` (−∇·(ρ∇u) = f, u = 0 on
the whole boundary); a solve's input is the element coefficient ρ and the
source is the configuration's constant ``load``."""


def build(mesh, problem: dict, device):
    from repro_torch.fem import PoissonProblem

    return PoissonProblem(mesh, device=device)


def solve(port, problem: dict, x, spec, call: dict):
    """``SolveResult`` of one solve on input ``x``."""
    kw = {k: v for k, v in call.items() if k in ("backend", "store")}
    return port.solve(rho=x, f=problem["load"], spec=spec, **kw)
