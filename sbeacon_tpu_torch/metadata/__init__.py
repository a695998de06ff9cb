from .entities import ENTITY_COLUMNS, ENTITY_KINDS, extract_terms
from .filters import entity_search_conditions
from .ontology import OntologyStore
from .store import MetadataStore

__all__ = [
    "ENTITY_COLUMNS",
    "ENTITY_KINDS",
    "MetadataStore",
    "OntologyStore",
    "entity_search_conditions",
    "extract_terms",
]
