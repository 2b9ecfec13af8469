"""partition_s.spinner: `partition_s` in the Spinner cells, whose jobs the card
paces, apart from the host-paced Revolver cells, so that its bound is set
from Spinner's own spread (see `metrics/partition_s.py`)."""
from partbench import harness

read = harness.load_reader("partition_s")
