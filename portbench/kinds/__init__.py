"""The runs of the traffic kinds: one module per `kind` of a traffic file."""
