"""Models of the port."""
from .bert import (BertForPretraining, BertForSequenceClassification,
                   BertModel, BertPretrainingCriterion)
from .gpt import GPTForGeneration

__all__ = ["BertForPretraining", "BertForSequenceClassification",
           "BertModel", "BertPretrainingCriterion", "GPTForGeneration"]
