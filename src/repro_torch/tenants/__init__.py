"""Multi-tenant curvature (torch port of ``repro.tenants``): one shared
base factor, per-tenant rank-r dual-space deltas (``delta`` — the
algebra) managed under a byte budget with spill-to-disk residency
(``manager`` — the memory model). ``SolveServer(tenants=)`` accepts
``tenant=`` on submit, and the batcher coalesces per-tenant
microbatches."""
from repro_torch.tenants.delta import (TenantDelta, augmented_window,
                                       delta_correction, delta_factor,
                                       delta_fold, delta_nbytes,
                                       init_tenant_delta, project_rows,
                                       tenant_factorization)
from repro_torch.tenants.manager import TenantManager, TenantStats

__all__ = [
    "TenantDelta",
    "init_tenant_delta",
    "project_rows",
    "delta_fold",
    "delta_correction",
    "delta_factor",
    "tenant_factorization",
    "augmented_window",
    "delta_nbytes",
    "TenantManager",
    "TenantStats",
]
