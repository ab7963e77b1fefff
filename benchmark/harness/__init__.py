"""The benchmark's harness: cells, inputs, weights, spans, traces, costs and
the comparison that decides `correct`. It imports the program
(selfcorr_tpu_torch) only inside the runners, never JAX."""
