"""Runtime subsystems: cluster simulator, fault schedules and recovery.

Submodules are imported lazily (PEP 562): the Chunks-and-Tasks scheduler
(`scheduler`, `trace`, `recovery`) is pure numpy/stdlib and stays
importable — and fast to import — without torch's CUDA context.  The
gradient-compression, fault-injection and elastic-remeshing names
(`compression`, `fault`, `elastic` in the reference) are not ported yet:
they raise :class:`NotImplementedError` naming their ROADMAP item.
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
}

#: gradient compression, fault tolerance and elastic remeshing of the
#: training loop: not ported yet
_NOT_PORTED = ("compressed_grad_tree", "dequantize_int8", "quantize_int8",
               "FaultInjector", "HeartbeatMonitor", "TrainingRunner",
               "elastic_remesh_plan", "reshard_tree")

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"repro_torch.runtime.{name} is not ported yet (ROADMAP.md, "
            f"queue 1 item 7: runtime/fault.py, elastic.py, compression.py)")
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{mod_name}", __name__)
    return getattr(mod, attr)


def __dir__():
    return sorted(__all__)
