"""Command-line tools of the port (the JAX package's tools/, adapted):
gen, rungen, traceviz, tilesearch and fitcost; `timer` is their frame
timer. The JAX package's abtest has no twin: K1 has no second window
buffer to switch."""
