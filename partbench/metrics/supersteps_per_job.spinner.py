"""supersteps_per_job.spinner: `supersteps_per_job` in the Spinner cells, whose jobs the card
paces, apart from the host-paced Revolver cells, so that its bound is set
from Spinner's own spread (see `metrics/supersteps_per_job.py`)."""
from partbench import harness

read = harness.load_reader("supersteps_per_job")
