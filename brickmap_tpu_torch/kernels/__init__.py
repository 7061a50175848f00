"""kernels of the brickmap port.

Each kernel wrapper counts its launches in ``<wrapper>.launches``.  The
timed ones (``traverse.trace``, ``record.record_segments``,
``extract.extract_fwd``, which reads the visited voxels from the pool
fields, ``extract.extract_bwd``, which adds their cotangents into the
field gradient in place, the wave's ``wave.primary``,
``wave.gather_clip``, ``wave.shade`` and ``wave.blit``, and
``adam.adam_update``, the optimizer's update with its clip) also have an
event hook: while ``<wrapper>.events`` is a list (it is ``None`` by default), each
launch appends the (start, end) CUDA events recorded around it on the
current stream, the kernel's own time without the wrapper's torch work.
"""


def hooked(wrapper, launcher, *args) -> int:
    """``launcher(*args)``, between two CUDA events appended to
    ``wrapper.events`` when that is a list."""
    events = wrapper.events
    if events is None:
        return launcher(*args)
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    status = launcher(*args)
    end.record()
    events.append((start, end))
    return status
