"""The benchmark's own machinery: finding configurations, traffic,
drivers, metric readers and count functions by name (:mod:`.registry`),
the one traffic generator (:mod:`.traffic`), the reduction of a device
trace (:mod:`.trace`), the table of peaks (:mod:`.peaks`) and the run of
one cell (:mod:`.cell`). Nothing here imports the measured program; the
drivers and the system modules do, inside their functions."""
