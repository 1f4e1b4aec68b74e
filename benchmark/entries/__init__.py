"""One module per entry point of the program that a cell's window drives;
a traffic mix names its entry."""
