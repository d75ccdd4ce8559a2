"""The plain references that a cell's outputs are held to, one module a
kind of run. A configuration file names its module under `"reference"`
(the module `objective`, the deep-photo objective under Adam, where it
names none), and `check.reference` calls that module's

    reference_run(config, params, pairs, steps, prec, rows, halo, device)
        -> (rows (B, steps, 5), images (B, H, W, 3))

on the request's pairs (`inputs.Pair`: content, style, and the class
masks, or None where the traffic leaves the masks to the program), the
run's weights, the `steps` to the request's first stamp, the precision
`prec` (`precision.PLAIN`, or `precision.FP8` for the control) and the
blocks of `rows` rows with `halo` rows on either side that the cell's
check file sets. Every module keeps to four rules:

- it returns the history rows (total, content, style, photoreal, tv at
  the image before each step) and the images after the last step, both
  float64 numpy arrays;
- it computes with TF32 off;
- it computes every operand that the configuration computes in bfloat16
  at `prec`, and the rest in float32 or wider;
- it imports nothing of `dpst_tpu_torch`, `dpst_tpu` or JAX, and takes
  nothing that the program has made: where the traffic leaves the masks
  to the program, the module makes its own.
"""
