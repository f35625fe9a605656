"""Runtime subsystems: cluster simulator, fault schedules and recovery,
the training loop's fault tolerance and gradient compression.

Submodules are imported lazily (PEP 562): the Chunks-and-Tasks scheduler
(`scheduler`, `trace`, `recovery`) is pure numpy/stdlib and stays
importable — and fast to import — without torch's CUDA context.
`compression` (int8 gradient round trip, torch ops) and `fault`
(heartbeats, failure injection, the restartable ``TrainingRunner``) run
on either device.  `elastic` plans a smaller mesh after failures and
moves a tree onto it (``reshard_tree``, by the parameter shardings).
"""
_EXPORTS = {
    # discrete-event Chunks-and-Tasks runtime simulator (DESIGN.md §4)
    "Scheduler": ("scheduler", "Scheduler"),
    "SimReport": ("scheduler", "SimReport"),
    "PLACEMENTS": ("scheduler", "PLACEMENTS"),
    "simulate": ("scheduler", "simulate"),
    "Trace": ("trace", "Trace"),
    "TaskEvent": ("trace", "TaskEvent"),
    "CriticalPath": ("trace", "CriticalPath"),
    "critical_path": ("trace", "critical_path"),
    # fault schedules + recovery policies for the simulator (DESIGN.md §10)
    "FaultEvent": ("recovery", "FaultEvent"),
    "FaultSchedule": ("recovery", "FaultSchedule"),
    "RecoveryManager": ("recovery", "RecoveryManager"),
    "kill": ("recovery", "kill"),
    "slow": ("recovery", "slow"),
    "join": ("recovery", "join"),
    "leave": ("recovery", "leave"),
    # gradient compression
    "compressed_grad_tree": ("compression", "compressed_grad_tree"),
    "dequantize_int8": ("compression", "dequantize_int8"),
    "quantize_int8": ("compression", "quantize_int8"),
    # fault tolerance of the training loop
    "FaultInjector": ("fault", "FaultInjector"),
    "HeartbeatMonitor": ("fault", "HeartbeatMonitor"),
    "TrainingRunner": ("fault", "TrainingRunner"),
    # elastic remeshing
    "RemeshPlan": ("elastic", "RemeshPlan"),
    "elastic_remesh_plan": ("elastic", "elastic_remesh_plan"),
    "reshard_tree": ("elastic", "reshard_tree"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{mod_name}", __name__)
    return getattr(mod, attr)


def __dir__():
    return sorted(__all__)
