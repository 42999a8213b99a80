"""Action labels, the frame-log files and state log, frame stores, the
device dataset and its iterators, evaluation statistics and ETL."""
