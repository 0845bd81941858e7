"""Workloads of the port (the benchmark ladder of BASELINE.json and the
reference regression suite, scripts/regression/namesConf.sh:20-35):
TeraSort on one card and across a slot mesh (``terasort.
distributed_terasort``), Sort, WordCount, SecondarySort, InvertedIndex,
Grep, Pi and DFSIO."""

from uda_tpu_torch.models import (dfsio, grep, inverted_index, pi, pipeline,
                                  secondary_sort, sort_job, terasort,
                                  wordcount)

__all__ = ["dfsio", "grep", "inverted_index", "pi", "pipeline",
           "secondary_sort", "sort_job", "terasort", "wordcount"]
