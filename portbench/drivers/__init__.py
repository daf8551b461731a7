"""One module per way of driving the port, named by a traffic file's
"driver" and loaded from its file by the harness. Each defines
`Cell(config, traffic, seed, device)`, a subclass of portbench.harness.Cell."""
