"""Matplotlib visualization and log viewing (torch port; optional —
matplotlib is imported lazily so headless deployments never pull it in)."""
