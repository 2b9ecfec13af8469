"""device_idle.spinner: `device_idle` in the Spinner cells, whose jobs the card
paces, apart from the host-paced Revolver cells, so that its bound is set
from Spinner's own spread (see `metrics/device_idle.py`)."""
from partbench import harness

read = harness.load_reader("device_idle")
