"""Peak device memory of the window: ``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats`` at its start, in MiB."""
from gpubench.readers import peak_mib as read  # noqa: F401
