"""The benchmark of matchtigs_tpu_torch: greedy matchtigs CLI runs on
synthetic pangenomes made on the card.  Run ``python3 port_bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the
repository's root."""
