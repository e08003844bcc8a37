"""Point-to-point messaging layer (reference: ompi/mca/pml/ and the JAX
package's ``ompi_tpu.pml``). The port has only the request helpers the
device collectives' requests need (:mod:`.request`); the host transports
come with the pml slice (ROADMAP queue 1 item 2)."""
