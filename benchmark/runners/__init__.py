"""One runner a traffic kind: `traffic/<name>.json`'s `kind` names the
module here whose `Runner` builds the cell's inputs and runs its window."""
