"""The drivers a traffic mix names by its `driver` key, one module each,
found by name: each has KIND, drive(cell, run, seed, seconds, trace, t0) ->
{name: check.Reading} (set-up, the window, the check) and control(cell,
seed, device, dtype) (the control's readings, for calibrate.py). A new kind
of loop is a new module here; a new mix of a loop is a data file."""
