"""Distribution helpers of the port (counterpart of ``repro.dist``); so far
the per-row int8 quantisation that the int8 distance kernel consumes."""
