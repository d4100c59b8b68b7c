"""Native modeling-API example (reference: examples/jump.jl).

The reference models through JuMP; the equivalent here is the
``proxsdp_tpu.Optimizer`` incremental builder.  Same problem: a 2x2 PSD
variable with bounds and one coupling inequality, maximized.
"""

import numpy as np  # noqa: F401

import proxsdp_tpu as px


def build_and_solve(verbose: bool = True):
    opt = px.Optimizer(
        log_verbose=verbose, tol_gap=1e-4, tol_feasibility=1e-4
    )
    X = opt.add_psd_var(2)
    x = int(X[0, 0])
    y = int(X[1, 1])

    opt.add_ineq_constraint({x: 1.0}, 2.0)           # x <= 2
    opt.add_ineq_constraint({y: 1.0}, 30.0)          # y <= 30
    opt.add_ineq_constraint({x: 1.0, y: 5.0}, 3.0)   # x + 5y <= 3
    opt.set_objective({x: 5.0, y: 3.0}, sense="max")

    res = opt.optimize()
    return res, res.primal[x], res.primal[y]


if __name__ == "__main__":
    res, x_val, y_val = build_and_solve()
    print(f"status        : {res.status_string}")
    print(f"objective     : {res.objval:.6f}")   # 5*2 + 3*0.2 = 10.6
    print(f"x = {x_val:.4f}, y = {y_val:.4f}")
