"""Host clock around the Stokes start (stokes_initial_guess), closed by a
device synchronisation; nothing where the traffic starts from rest."""


def read(run):
    return run.get("stokes_s")
