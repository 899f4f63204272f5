"""Host agents of the port: failure detection, restarts and stragglers
(`fault_tolerance`), and elastic membership over the control tree
(`elastic`)."""
