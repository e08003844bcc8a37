"""Core services of the port: cvars, pvars, output streams, the MPI_T
events plane (:mod:`.events`), the framework registry (:mod:`.registry`)
and the init / finalize hooks (:mod:`.hook`)."""
