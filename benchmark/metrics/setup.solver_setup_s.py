"""Host clock around NavierStokesSolver.setup(), closed by a device
synchronisation."""


def read(run):
    return run["solver_setup_s"]
