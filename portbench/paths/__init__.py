"""A path is the CLI entry a cell times, and what its check compares.

A path module provides ``ITEMS`` (what a pass counts), ``RATE`` (its
end-to-end rate's name), ``SPANS`` (program calls labelled in the traced
run), ``make_inputs(cell, seed, work)``, ``setup(inputs, device)``,
``run_pass(state, inputs, output)``, ``digest(output)``,
``check(inputs, device, overrides)`` (the reference's output),
``write_output(want, output)`` and ``compare(inputs, output, want)`` ((name,
count) pairs, all 0 when the output is right); optionally
``replay(state, inputs)`` for its kernel's roofline.
"""
