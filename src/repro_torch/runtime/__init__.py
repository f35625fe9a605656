"""Runtime subsystems: cluster simulator, fault schedules and recovery,
the training loop's fault tolerance and gradient compression.

Submodules are imported lazily (PEP 562): the Chunks-and-Tasks scheduler
(`scheduler`, `trace`, `recovery`) is pure numpy/stdlib and stays
importable — and fast to import — without torch's CUDA context.
`compression` (int8 gradient round trip, torch ops) and `fault`
(heartbeats, failure injection, the restartable ``TrainingRunner``) run
on either device.  Elastic remeshing (`elastic` in the reference) is not
ported yet: its names raise :class:`NotImplementedError` naming ROADMAP.md
queue 1 item 7.
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
}

#: elastic remeshing of the training loop: not ported yet
_NOT_PORTED = ("elastic_remesh_plan", "reshard_tree")

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"repro_torch.runtime.{name} is not ported yet (ROADMAP.md, "
            f"queue 1 item 7: runtime/elastic.py)")
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{mod_name}", __name__)
    return getattr(mod, attr)


def __dir__():
    return sorted(__all__)
