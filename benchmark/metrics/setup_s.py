"""setup_s: process start to the window's start (inputs from the seed, the
graph build, the model, the check's first steps or the request pool, and
the warm-up; the first run in a checkout also compiles)."""


def read(run):
    return run.setup_s
